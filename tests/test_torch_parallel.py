"""The port's multi-device layer against the JAX package: the named-axis
collectives, the placements and ``init_distributed``.

The collectives take the same seeded numpy inputs as the JAX package's under
``shard_map`` on the 8 virtual CPU devices of ``tests/conftest.py``, on a
port mesh of ``cpu`` positions, and must give equal values. Position
``(d, s)`` holds block ``d * shard + s`` of the input (the JAX in_specs
``P(("dp", "shard"))``). ``init_distributed``'s decision logic runs with
``dist.init_process_group`` stubbed, as ``tests/test_distributed_init.py``
pins the JAX package's; one real run starts two gloo processes, each with a
local mesh of two ``cpu`` positions, over a ``file://`` rendezvous.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from libzkp_tpu.parallel import collective as jcollective
from libzkp_tpu_torch.parallel import collective, mesh as meshmod

REPO = Path(__file__).resolve().parent.parent
ROWS = 4  # rows of the input a position holds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _input(dp: int, shard: int, dtype, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (dp * shard * ROWS, 4, 3)
    if dtype == np.uint32:  # near the top, so sums wrap
        return rng.integers((1 << 32) - 1000, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)


def _reference(fn, x: np.ndarray, dp: int, shard: int) -> np.ndarray:
    """``fn`` under ``shard_map`` on a (dp, shard) mesh of virtual CPU
    devices; each position's result gets a leading axis, so the output is
    the positions' results stacked in (d, s) order."""
    mesh = JMesh(np.asarray(jax.devices()[: dp * shard]).reshape(dp, shard), ("dp", "shard"))
    spec = P(("dp", "shard"))
    run = shard_map(lambda xl: fn(xl)[None], mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(x)))


def _port(fn, x: np.ndarray, dp: int, shard: int) -> np.ndarray:
    """``fn(parts, mesh)`` on a (dp, shard) mesh of ``cpu`` positions, with
    position (d, s) holding block d * shard + s; the results stacked in
    (d, s) order."""
    mesh = meshmod.get_mesh(dp=dp, shard=shard, devices=["cpu"] * (dp * shard))
    blocks = torch.from_numpy(x).chunk(dp * shard)
    parts = tuple(tuple(blocks[d * shard + s] for s in range(shard)) for d in range(dp))
    out = fn(parts, mesh)
    assert len(out) == dp and all(len(row) == shard for row in out)
    return np.stack([np.asarray(p) for row in out for p in row])


MESHES = [(2, 2), (1, 4), (4, 2)]  # (4, 2): dryrun_multichip(8)'s layout
AXES = ["dp", "shard"]

# (name, JAX function of the local block and the axis, port function of the
# parts, the mesh and the axis)
CASES = [
    ("psum", lambda xl, a: jcollective.psum(xl, a),
     lambda x, m, a: collective.psum(x, a, mesh=m)),
    ("all_gather", lambda xl, a: jcollective.all_gather(xl, a),
     lambda x, m, a: collective.all_gather(x, a, mesh=m)),
    ("all_gather_axis1", lambda xl, a: jcollective.all_gather(xl, a, gather_axis=1),
     lambda x, m, a: collective.all_gather(x, a, mesh=m, gather_axis=1)),
    ("all_gather_tiled", lambda xl, a: jcollective.all_gather(xl, a, tiled=True),
     lambda x, m, a: collective.all_gather(x, a, mesh=m, tiled=True)),
    ("all_gather_tiled_axis2", lambda xl, a: jcollective.all_gather(xl, a, gather_axis=2, tiled=True),
     lambda x, m, a: collective.all_gather(x, a, mesh=m, gather_axis=2, tiled=True)),
    ("all_to_all_0_1", lambda xl, a: jcollective.all_to_all(xl, a, 0, 1),
     lambda x, m, a: collective.all_to_all(x, a, 0, 1, mesh=m)),
    ("all_to_all_1_0", lambda xl, a: jcollective.all_to_all(xl, a, 1, 0),
     lambda x, m, a: collective.all_to_all(x, a, 1, 0, mesh=m)),
    ("ppermute_ring", lambda xl, a: jcollective.ppermute(xl, a, _ring(a)),
     None),
    ("ppermute_one", lambda xl, a: jcollective.ppermute(xl, a, [(0, 1)] if jax.lax.axis_size(a) > 1 else []),
     None),
]


def _ring(axis: str):
    n = jax.lax.axis_size(axis)
    return [(i, (i + 1) % n) for i in range(n)]


def _port_ppermute(name: str, x, m, a):
    n = collective.axis_size(a, mesh=m)
    perm = [(i, (i + 1) % n) for i in range(n)] if name == "ppermute_ring" else ([(0, 1)] if n > 1 else [])
    return collective.ppermute(x, a, perm, mesh=m)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32], ids=["uint32", "int32"])
@pytest.mark.parametrize("dp,shard", MESHES)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_collective_matches_jax(case, axis, dp, shard, dtype):
    """Each collective over each axis of a (2, 2), a (1, 4) and a (4, 2)
    mesh gives the JAX collective's values exactly (uint32 sums wrap mod
    2^32)."""
    name, jfn, tfn = case
    if tfn is None:
        tfn = lambda x, m, a: _port_ppermute(name, x, m, a)  # noqa: E731
    x = _input(dp, shard, dtype, seed=zlib.crc32(f"{name} {axis} {dp} {shard}".encode()))
    want = _reference(lambda xl: jfn(xl, axis), x, dp, shard)
    got = _port(lambda parts, m: tfn(parts, m, axis), x, dp, shard)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dp,shard", MESHES)
@pytest.mark.parametrize("axis", AXES)
def test_all_to_all_untiled_matches_jax(axis, dp, shard):
    """``tiled=False``: the split axis has one entry per member and goes;
    the senders stack on a new axis."""
    n = dp if axis == "dp" else shard
    x = np.random.default_rng(7).integers(0, 1 << 20, (dp * shard * n, 5, 2), dtype=np.int64).astype(np.int32)
    want = _reference(lambda xl: jcollective.all_to_all(xl, axis, 0, 1, tiled=False), x, dp, shard)
    got = _port(lambda parts, m: collective.all_to_all(parts, axis, 0, 1, mesh=m, tiled=False), x, dp, shard)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dp,shard", MESHES)
@pytest.mark.parametrize("axis", AXES)
def test_axis_index_and_size_match_jax(axis, dp, shard):
    x = np.zeros((dp * shard, 1), dtype=np.int32)
    want = _reference(lambda xl: jnp.stack([jcollective.axis_index(axis), jcollective.axis_size(axis)]), x,
                      dp, shard)
    mesh = meshmod.get_mesh(dp=dp, shard=shard, devices=["cpu"] * (dp * shard))
    idx = collective.axis_index(axis, mesh=mesh)
    got = [[idx[d][s], collective.axis_size(axis, mesh=mesh)] for d in range(dp) for s in range(shard)]
    np.testing.assert_array_equal(np.asarray(got), want)


def test_float_psum_and_bad_arguments():
    """A float psum sums; a bad axis, a bad permutation, an uneven split and
    parts of another layout raise."""
    mesh = meshmod.get_mesh(dp=2, shard=2, devices=["cpu"] * 4)
    parts = meshmod.replicated(mesh).put(torch.ones(3, dtype=torch.float64))
    assert all(torch.equal(p, torch.full((3,), 2.0, dtype=torch.float64))
               for row in collective.psum(parts, "shard", mesh=mesh) for p in row)
    with pytest.raises(ValueError, match="no mesh axis"):
        collective.psum(parts, "model", mesh=mesh)
    with pytest.raises(ValueError, match="no permutation"):
        collective.ppermute(parts, "dp", [(0, 1), (1, 1)], mesh=mesh)
    with pytest.raises(ValueError, match="does not split"):
        collective.all_to_all(parts, "dp", 0, 0, mesh=mesh)
    with pytest.raises(ValueError, match="positions"):
        collective.psum(parts[:1], "dp", mesh=mesh)


def test_placements():
    """``dp_sharding`` puts block d of the leading axis on every position of
    row d (contiguous blocks of ceil(B / dp) rows, no padding);
    ``replicated`` the whole tensor on every position; a ``shard`` split
    block s on every position of column s."""
    mesh = meshmod.get_mesh(dp=3, shard=2, devices=["cpu"] * 6)
    x = torch.arange(14).reshape(7, 2)
    parts = meshmod.dp_sharding(mesh).put(x)
    assert [[p.tolist() for p in row] for row in parts] == [
        [x[0:3].tolist()] * 2, [x[3:6].tolist()] * 2, [x[6:7].tolist()] * 2]
    assert all(torch.equal(p, x) for row in meshmod.replicated(mesh).put(x) for p in row)
    cols = meshmod.Sharding(mesh, "shard").put(x)
    assert [[p.tolist() for p in row] for row in cols] == [[x[0:4].tolist(), x[4:7].tolist()]] * 3
    small = meshmod.dp_sharding(mesh).put(x[:2])
    assert [row[0].shape[0] for row in small] == [1, 1, 0]
    with pytest.raises(ValueError, match="no mesh axis"):
        meshmod.Sharding(mesh, "model").put(x)


# ---------------------------------------------------------------------------
# init_distributed
# ---------------------------------------------------------------------------

_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "TPU_WORKER_HOSTNAMES")


class _Spy:
    def __init__(self, fail: bool = False):
        self.calls = []
        self.fail = fail

    def __call__(self, backend, init_method=None, world_size=-1, rank=-1):
        if self.fail:
            raise RuntimeError("rendezvous timed out")
        self.calls.append((backend, init_method, world_size, rank))


@pytest.fixture
def spy(monkeypatch):
    """``dist.init_process_group`` stubbed (the group is "up" once it was
    called), the environment cleared of every name the bootstrap reads."""
    s = _Spy()
    monkeypatch.setattr(dist, "init_process_group", s)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(s.calls))
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    return s


def test_init_single_host_noop(spy, monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b,c")  # no auto-discovery
    assert meshmod.init_distributed() is False
    assert spy.calls == []


def test_init_explicit_args(spy):
    assert meshmod.init_distributed("10.0.0.1:1234", 4, 2) is True
    assert spy.calls == [("gloo", "tcp://10.0.0.1:1234", 4, 2)]


def test_init_reference_env(spy, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "head:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "8")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setenv("MASTER_ADDR", "other")  # the reference's names come first
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert meshmod.init_distributed() is True
    assert spy.calls == [("gloo", "tcp://head:8476", 8, 3)]


def test_init_coordinator_address_env(spy, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "head:9")
    assert meshmod.init_distributed(num_processes=2, process_id=1) is True
    assert spy.calls == [("gloo", "tcp://head:9", 2, 1)]


def test_init_torchrun_env(spy, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    assert meshmod.init_distributed() is True
    assert spy.calls == [("gloo", "tcp://node0:29500", 4, 1)]


def test_init_scheme_passes_and_nccl_with_cuda(spy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert meshmod.init_distributed("file:///tmp/rdzv", 1, 0) is True
    assert spy.calls == [("nccl", "file:///tmp/rdzv", 1, 0)]


def test_init_idempotent(spy):
    assert meshmod.init_distributed("head:1", 2, 0) is True
    assert meshmod.init_distributed("head:2", 3, 1) is True
    assert meshmod.init_distributed() is True
    assert len(spy.calls) == 1


def test_init_failure_raises(spy, monkeypatch):
    """A failed init raises and leaves no group; an address without a
    process count or index raises before any init."""
    monkeypatch.setattr(dist, "init_process_group", _Spy(fail=True))
    with pytest.raises(RuntimeError, match="timed out"):
        meshmod.init_distributed("head:1", 2, 0)
    assert meshmod.init_distributed() is False
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES or WORLD_SIZE"):
        meshmod.init_distributed("head:1")
    with pytest.raises(ValueError, match="JAX_PROCESS_ID or RANK"):
        meshmod.init_distributed("head:1", 2)


def test_mesh_spans_processes_after_init(monkeypatch):
    """With a group of 3 up and this process third, a local (2, 2) mesh's
    dp has 6 members and its rows are global rows 4 and 5; shard stays
    local; ``all_to_all`` and ``ppermute`` over that dp hand the exchange
    to ``torch.distributed`` (stubbed here)."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    mesh = meshmod.get_mesh(dp=2, shard=2, devices=["cpu"] * 4)
    assert (mesh.processes, mesh.process_index, mesh.shape) == (3, 2, {"dp": 2, "shard": 2})
    assert collective.axis_size("dp", mesh=mesh) == 6
    assert collective.axis_size("shard", mesh=mesh) == 2
    assert collective.axis_index("dp", mesh=mesh) == ((4, 4), (5, 5))
    assert collective.axis_index("shard", mesh=mesh) == ((0, 1), (0, 1))
    parts = meshmod.replicated(mesh).put(torch.arange(12, dtype=torch.int32))
    # all_to_all over the global dp: one exchange a shard column, every
    # (process, local source, local destination) chunk of 2, as int64
    sent = []

    def a2a(recv, send):
        sent.append((tuple(send.shape), send.dtype))
        recv.copy_(send)  # as if every process sent what this one does

    monkeypatch.setattr(dist, "all_to_all_single", a2a)
    out = collective.all_to_all(parts, "dp", 0, 0, mesh=mesh)
    assert sent == [((3, 2, 2, 2), torch.int64)] * 2
    # local member e (global 4 + e) gets, from each source (q, d) in axis
    # order, the chunk that source's part owes member 2q + e
    assert out[1][0].tolist() == [2, 3, 2, 3, 6, 7, 6, 7, 10, 11, 10, 11]
    assert out[0][1].dtype == torch.int32
    # ppermute over the global dp: the pairs leaving or entering this
    # process's members 4 and 5 are posted at once; 0 -> 1 is none of its
    posted = []
    monkeypatch.setattr(dist, "P2POp", lambda op, tensor, peer, tag=0: SimpleNamespace(op=op, peer=peer))
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: posted.append([(o.op.__name__, o.peer) for o in ops]) or [])
    collective.ppermute(parts, "dp", [(4, 0), (1, 5), (0, 1)], mesh=mesh)
    assert posted == [[("isend", 0), ("irecv", 0), ("isend", 0), ("irecv", 0)]]
    got = collective.ppermute(parts, "dp", [(0, 1)], mesh=mesh)
    assert len(posted) == 1 and all(not p.any() for row in got for p in row)
    # within a process, shard still exchanges
    assert collective.ppermute(parts, "shard", [(0, 1)], mesh=mesh)[0][1].shape == (12,)


# ---------------------------------------------------------------------------
# One real run: two gloo processes
# ---------------------------------------------------------------------------

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from libzkp_tpu_torch.parallel import collective, mesh as meshmod

rank, rdzv, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
assert meshmod.init_distributed(f"file://{rdzv}", 2, rank) is True
assert meshmod.init_distributed() is True and dist.get_backend() == "gloo"
mesh = meshmod.get_mesh(dp=2, devices=["cpu"] * 2)
x = np.load(inp)
per = len(x) // 2
mine = torch.from_numpy(x[rank * per : (rank + 1) * per])
parts = meshmod.dp_sharding(mesh).put(mine)
res = {
    "psum": collective.psum(parts, "dp", mesh=mesh),
    "gather": collective.all_gather(parts, "dp", mesh=mesh),
    "gather_tiled": collective.all_gather(parts, "dp", mesh=mesh, gather_axis=1, tiled=True),
    "a2a": collective.all_to_all(parts, "dp", 0, 1, mesh=mesh),
    "a2a_untiled": collective.all_to_all(parts, "dp", 0, 1, mesh=mesh, tiled=False),
    "ring": collective.ppermute(parts, "dp", RING, mesh=mesh),
    "pairs": collective.ppermute(parts, "dp", PAIRS, mesh=mesh),
}
np.savez(out, **{k: np.stack([np.asarray(row[0]) for row in v]) for k, v in res.items()},
         index=np.asarray([row[0] for row in collective.axis_index("dp", mesh=mesh)]),
         size=np.asarray(collective.axis_size("dp", mesh=mesh)))
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank}))
"""
RING = [(i, (i + 1) % 4) for i in range(4)]
PAIRS = [(0, 3), (2, 1), (1, 0)]  # across processes both ways, within one; member 2 gets zeros
WORKER = f"RING, PAIRS = {RING!r}, {PAIRS!r}\n" + WORKER


def test_two_gloo_processes_match_jax(tmp_path):
    """Two processes, each a local mesh of two ``cpu`` positions, over a
    ``file://`` rendezvous: ``psum``, ``all_gather``, ``all_to_all`` (tiled
    and untiled) and ``ppermute`` (a ring, and pairs across the processes
    both ways, within one, and to no member) over the global dp of 4 equal
    the JAX collectives on 4 virtual devices, and ``axis_index`` is
    global."""
    x = _input(4, 1, np.uint32, seed=11)
    np.save(tmp_path / "x.npy", x)
    env = {k: v for k, v in os.environ.items() if k not in _ENV}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp_path / "rdzv"),
                               str(tmp_path / "x.npy"), str(tmp_path / f"out{r}.npz")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [r["rank"] for r in results] == [0, 1]

    def ref(fn):
        return _reference(fn, x, 4, 1)  # one entry per global dp position

    want = {"psum": ref(lambda xl: jcollective.psum(xl, "dp")),
            "gather": ref(lambda xl: jcollective.all_gather(xl, "dp")),
            "gather_tiled": ref(lambda xl: jcollective.all_gather(xl, "dp", gather_axis=1, tiled=True)),
            "a2a": ref(lambda xl: jcollective.all_to_all(xl, "dp", 0, 1)),
            "a2a_untiled": ref(lambda xl: jcollective.all_to_all(xl, "dp", 0, 1, tiled=False)),
            "ring": ref(lambda xl: jcollective.ppermute(xl, "dp", RING)),
            "pairs": ref(lambda xl: jcollective.ppermute(xl, "dp", PAIRS))}
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for key, w in want.items():
        got = np.concatenate([o[key] for o in outs])
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    assert np.concatenate([o["index"] for o in outs]).tolist() == [0, 1, 2, 3]
    assert [int(o["size"]) for o in outs] == [4, 4]
