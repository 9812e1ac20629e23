"""The port's sharded consumers against the JAX package: the four-step NTT
over a mesh's ``shard`` axis, the dp split of ``coset_lde_batch`` and the
multi-device dry run.

The JAX functions run as the JAX package's own tests run them, on the 8
virtual CPU devices of ``tests/conftest.py``; the port's on meshes of
``cpu`` positions. Values must be equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from libzkp_tpu.ops import ntt as jntt
from libzkp_tpu_torch.ops import ntt
from libzkp_tpu_torch.ops.field import BN254_FR, F128
from libzkp_tpu_torch.parallel import mesh as meshmod
from libzkp_tpu_torch.parallel.dryrun import dryrun_multichip

FIELDS = {"f128": F128, "bn254_fr": BN254_FR}
LDE_OFFSET = 3  # the STARK domain offset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_mesh():
    meshmod.set_mesh(None)
    yield
    meshmod.set_mesh(None)


def _jmesh(dp: int, shard: int) -> JMesh:
    return JMesh(np.asarray(jax.devices()[: dp * shard]).reshape(dp, shard), ("dp", "shard"))


def _cpu_mesh(dp: int, shard: int) -> meshmod.Mesh:
    return meshmod.get_mesh(dp=dp, shard=shard, devices=["cpu"] * (dp * shard))


def _values(F, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(n)]


@pytest.mark.parametrize("invert", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("shard", [2, 4])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("field", FIELDS)
def test_ntt_sharded_matches_jax_and_ntt_py(field, n, shard, invert):
    """The four-step NTT over ``shard`` positions (dp 2 on the port's mesh,
    whose first row runs it) equals the JAX ``ntt_sharded`` on a (1, shard)
    virtual mesh and ``ntt_py``."""
    F = FIELDS[field]
    vals = _values(F, n, seed=n * 10 + shard + invert)
    got = ntt.ntt_sharded(F.p, vals, _cpu_mesh(2, shard), invert=invert)
    assert got == ntt.ntt_py(F, vals, invert=invert)
    assert got == jntt.ntt_sharded(F.p, vals, _jmesh(1, shard), invert=invert)


@pytest.mark.parametrize("n,shard", [(64, 2), (64, 4), (256, 4), (16, 4), (4, 2)])
def test_four_step_shape_matches_jax(n, shard):
    """N1 and N2 are the JAX package's choice: 2^(log n // 2), raised to
    the shard count where a factor does not divide by it."""
    n1, n2 = ntt.four_step_shape(n, shard)
    lg = n.bit_length() - 1
    j1 = 1 << (lg // 2)
    if j1 % shard or (n // j1) % shard:
        j1 = max(j1, shard)
    assert (n1, n2) == (j1, n // j1)
    assert n1 % shard == 0 and n2 % shard == 0
    want = np.asarray(jntt._four_step_twiddles(F128.p, n1, n2, False))
    np.testing.assert_array_equal(ntt._four_step_twiddles(F128.p, n1, n2, False), want)


@pytest.mark.parametrize("n,shard", [(8, 4), (32, 8), (12, 2)])
def test_ntt_sharded_too_small_raises_as_jax(n, shard):
    """N below shard^2 (or no power of two) raises ``AssertionError`` in
    both packages."""
    F = F128
    vals = list(range(n))
    with pytest.raises(AssertionError):
        ntt.ntt_sharded(F.p, vals, _cpu_mesh(1, shard))
    with pytest.raises(AssertionError):
        jntt.ntt_sharded(F.p, vals, _jmesh(1, shard))


def _traces(count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(16), "little") % F128.p for _ in range(8)] for _ in range(count)]


@pytest.mark.parametrize("dp,shard,count", [(1, 1, 16), (2, 1, 16), (4, 1, 16), (2, 2, 16), (4, 1, 3),
                                            (4, 2, 5)])
def test_coset_lde_batch_split_matches_jax(dp, shard, count):
    """``coset_lde_batch`` on a (dp, shard) mesh of ``cpu`` positions equals
    the JAX ``coset_lde_batch(..., mesh=)`` on a (dp, 1) virtual mesh and
    the one-device route (16 traces of 8, blowup 8; a batch of 3 at dp 4
    takes three blocks)."""
    traces = _traces(count, seed=dp * 100 + count)
    got = ntt.coset_lde_batch(F128.p, traces, 8, LDE_OFFSET, device="cpu", mesh=_cpu_mesh(dp, shard))
    want = jntt.coset_lde_batch(F128.p, traces, 8, LDE_OFFSET, mesh=_jmesh(dp, 1))
    assert got == tuple(want)
    assert got == ntt.coset_lde_batch(F128.p, traces, 8, LDE_OFFSET, device="cpu")


def test_coset_lde_batch_blocks_and_default_mesh(monkeypatch):
    """A batch of 3 at dp 4 runs three blocks of one trace, each on its row's
    first device; without ``mesh=`` the mesh ``set_mesh`` names is taken; a
    mesh of another device type raises."""
    calls = []
    run = ntt.coset_lde_device
    monkeypatch.setattr(ntt, "coset_lde_device", lambda ctx, x, *a: calls.append(x.shape[0]) or run(ctx, x, *a))
    traces = _traces(3, seed=5)
    mesh = _cpu_mesh(4, 1)
    meshmod.set_mesh(mesh)
    got = ntt.coset_lde_batch(F128.p, traces, 8, LDE_OFFSET, device="cpu")
    assert calls == [1, 1, 1]
    meshmod.set_mesh(None)
    calls.clear()
    assert got == ntt.coset_lde_batch(F128.p, traces, 8, LDE_OFFSET, device="cpu")
    assert calls == [3]
    fake = meshmod.Mesh(((torch.device("cuda", 0),) * 2,))
    with pytest.raises(ValueError, match="entry device"):
        ntt.coset_lde_batch(F128.p, traces, 8, LDE_OFFSET, device="cpu", mesh=fake)


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip_on_cpu(n_devices):
    """The dry run on ``n_devices`` repeated ``cpu`` positions: shard 2,
    dp n / 2, every path equal to its host golden."""
    out = dryrun_multichip(n_devices, device="cpu")
    assert out["mesh"] == {"dp": n_devices // 2, "shard": 2}
    assert out["devices"] == ["cpu"] * n_devices
    assert out["batch"] == n_devices and out["ntt_sharded_n"] == [64]
