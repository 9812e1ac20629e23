"""The port's mesh-sharded MSM against the JAX package and the host golden
tier: the plain versions of the tree-sum (A6) and BN254 Horner kernels, the
cross-shard fold, ``msm_many_sharded`` on CPU meshes, the mesh itself and the
seam's mesh route.

The JAX side runs as its own tests run it on the CPU: each Pallas factory
returns its jnp branch, and the sharded MSM runs on the 8 virtual CPU devices
of ``tests/conftest.py``. Limbs must be identical where the operation order
is the JAX one; otherwise points must be equal.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import curve_jax as cj
from libzkp_tpu.parallel import collective as jcollective
from libzkp_tpu.parallel import mesh as jmesh
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.ops import curve as tc
from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import kernels, msm_device
from libzkp_tpu_torch.ops.weierstrass import CURVES, get_engine
from libzkp_tpu_torch.parallel import collective, mesh as meshmod

CPU = torch.device("cpu")


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


def _rand_points(curve, rng, k):
    if curve == "ed25519":
        return [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(k)]
    if curve == "bn254_g1":
        g = bn.g1_from_affine(bn.G1_GEN)
        return [bn.g1_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(k)]
    g = bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y))
    return [bn.g2_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(k)]


def _same_point(curve, a, b) -> bool:
    if curve == "ed25519":
        return ed.point_equal(tuple(a), tuple(b))
    if curve == "bn254_g1":
        return bn.g1_to_affine(a) == bn.g1_to_affine(b)
    return bn.g2_to_affine(a) == bn.g2_to_affine(b)


def _host_msm(curve, sv, pts):
    return {"ed25519": ed.msm, "bn254_g1": bn.g1_msm, "bn254_g2": bn.g2_msm}[curve](sv, pts)


@pytest.fixture(scope="module", params=CURVES)
def tables(request):
    """A 7-point basis of each curve and its multiples table (the port's
    plain table-add chain, Kp = 8): its rows are relaxed limbs, as the
    kernels see them."""
    curve = request.param
    eng = get_engine(curve)
    pts = _rand_points(curve, random.Random(21), 7)
    table = tc.DeviceTable(eng.encode_points(pts), device=CPU, curve=curve)
    return dict(curve=curve, eng=eng, pts=pts, table=table, ct=table.consts,
                jc=jnp.asarray(eng.consts_np))


def test_tree_sum_plain_matches_jax_window_sum(tables):
    """Gathered table rows, an odd Kp (the odd-carry branch of
    ``_tree_reduce``): the port's tree sum in its lane-major layout gives
    the JAX ``_window_sum_call`` CPU branch's limbs on the same points in
    JAX's (Kp, C, n, B) layout."""
    c = tables
    Kp, B = 7, 4
    digits = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (Kp, B)).astype(np.int32))
    pts = kernels._gather(c["table"].table, digits)  # (B, Kp, C, n) int16
    assert pts.dtype == torch.int16 and pts.shape == (B, Kp, c["eng"].coords, c["eng"].n)
    got = kernels.tree_sum(c["ct"], pts, curve=c["curve"])
    want = cj._window_sum_call(c["curve"], Kp, B)(c["jc"], jnp.asarray(pts.permute(1, 2, 3, 0).numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not any(kernels.launches().values())


@pytest.mark.parametrize("curve", ("bn254_g1", "bn254_g2"))
def test_horner_plain_bn254_matches_jax(curve):
    """K2's plain version on BN254 lanes against the JAX ``_horner_call`` CPU
    branch: identical limbs."""
    eng = get_engine(curve)
    pts = _rand_points(curve, random.Random(22), 4)
    ct = torch.from_numpy(eng.consts_np)
    lanes = torch.from_numpy(np.ascontiguousarray(np.transpose(eng.encode_points(pts), (1, 2, 0))))
    acc = eng.padd(ct, lanes, lanes.roll(1, -1))  # relaxed limbs
    wsum = eng.padd(ct, acc, lanes)
    got = kernels.horner(ct, acc, wsum, curve=curve)
    want = cj._horner_call(curve, 4)(jnp.asarray(eng.consts_np), jnp.asarray(acc.numpy()),
                                     jnp.asarray(wsum.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reduce_points_matches_jax_pairing():
    """Three partial sums (shard = 3, one odd part carried a level): the
    port's fold gives the limbs of JAX ``collective.reduce_points`` under
    ``shard_map`` over 3 CPU devices."""
    from jax import shard_map
    from jax.sharding import Mesh as JMesh, PartitionSpec as P

    eng = get_engine("ed25519")
    jeng = cj.edwards_engine()
    ct = torch.from_numpy(eng.consts_np)
    pts = _rand_points("ed25519", random.Random(23), 12)
    parts = [torch.from_numpy(np.ascontiguousarray(np.transpose(eng.encode_points(pts[4 * i : 4 * i + 4]),
                                                                 (1, 2, 0)))) for i in range(3)]
    parts = [eng.padd(ct, p, p.roll(1, -1)) for p in parts]  # relaxed limbs
    got = collective.reduce_points(lambda a, b: kernels.pair_add(ct, a, b), parts)

    jc = jnp.asarray(eng.consts_np)
    fn = shard_map(
        lambda x: jcollective.reduce_points(lambda a, b: jeng.padd(jc, a, b), x[0], axis="shard"),
        mesh=JMesh(np.asarray(jax.devices()[:3]), ("shard",)),
        in_specs=P("shard"), out_specs=P(), check_vma=False,
    )
    want = jax.jit(fn)(jnp.asarray(torch.stack(parts).numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ed25519_sharded_matches_jax_sharded_and_host():
    """K = 6 over a (dp 4, shard 2) mesh of 8 CPU positions, B = 5 (K not a
    multiple of shard, B not of dp: both pad), on the JAX table's limbs: the
    decoded points equal JAX ``msm_many_sharded``'s on its 8-device virtual
    mesh and the host golden MSM."""
    rng = random.Random(24)
    K, B = 6, 5
    pts = _rand_points("ed25519", rng, K)
    vecs = [[rng.randrange(ed.L) for _ in range(K)] for _ in range(B)]
    vecs[0] = [0] * K
    jt = cj.build_table_ed25519(pts)
    want = cj.msm_many_sharded(jt, vecs, mesh=jmesh.get_mesh(dp=4, shard=2))
    mesh = meshmod.get_mesh(dp=4, shard=2, devices=[CPU] * 8)
    table = convert.sharded_table(np.asarray(jt.table), K, mesh, curve="ed25519")
    assert (table.k_local, table.Kp) == (8, 16)
    got = tc.msm_many_sharded(table, vecs, mesh)
    assert [tuple(g) for g in got] == [tuple(w) for w in want]
    for sv, g in zip(vecs, got):
        assert ed.point_equal(tuple(g), ed.msm(sv, pts))
    assert not any(kernels.launches().values())


@pytest.mark.parametrize("curve,K,B", [("bn254_g1", 5, 4), ("bn254_g2", 3, 3)])
def test_bn254_sharded_matches_single_device_and_host(curve, K, B):
    """BN254 G1 and G2 over a (dp 2, shard 2) CPU mesh, the port's
    DeviceTable cut by ``msm_many_sharded``: the points equal the port's
    single-device ``msm_many`` (v4) and the host golden MSM."""
    rng = random.Random(25)
    eng = get_engine(curve)
    pts = _rand_points(curve, rng, K)
    vecs = [[rng.randrange(bn.R) for _ in range(K)] for _ in range(B)]
    vecs[0] = [0] * K
    vecs[1][0] = bn.R - 1
    table = tc.DeviceTable(eng.encode_points(pts), device=CPU, curve=curve)
    mesh = meshmod.get_mesh(dp=2, shard=2, devices=[CPU] * 4)
    got = tc.msm_many_sharded(table, vecs, mesh)
    single = tc.msm_many(table, vecs)
    for sv, g, s in zip(vecs, got, single, strict=True):
        assert _same_point(curve, g, s)
        assert _same_point(curve, g, _host_msm(curve, sv, pts))


def test_get_mesh_shapes_padding_and_errors(monkeypatch):
    cpus = [CPU] * 5
    m = meshmod.get_mesh(shard=2, devices=cpus)  # dp = 5 // 2, the fifth device unused
    assert m.shape == {"dp": 2, "shard": 2} and m.size == 4
    assert meshmod.num_dp(m) == 2 and m.device_type == "cpu"
    assert meshmod.get_mesh(dp=1, shard=1, devices=cpus).size == 1
    assert meshmod.pad_to_multiple(5, 4) == 8 and meshmod.pad_to_multiple(8, 4) == 8
    assert m == meshmod.get_mesh(dp=2, shard=2, devices=cpus) and hash(m) == hash(
        meshmod.get_mesh(dp=2, shard=2, devices=cpus))
    with pytest.raises(ValueError, match="needs 6 devices, 5 given"):
        meshmod.get_mesh(dp=3, shard=2, devices=cpus)
    with pytest.raises(ValueError, match="one type"):
        meshmod.get_mesh(dp=2, shard=1, devices=[CPU, torch.device("meta")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((1, False), (2, True), (4, True)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert meshmod.use_mesh() is want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not meshmod.use_mesh()


def test_sharded_table_pads_with_identity_rows():
    """The JAX padding arithmetic at the Groth16 query shapes, shard = 2:
    Kp 352 -> k_local 192 and Kp 512 -> 256; rows past the basis (if any)
    are the identity, every block of a column holds the same slice."""
    eng = get_engine("bn254_g1")
    ident = torch.from_numpy(eng.identity_np().astype(np.int16))
    mesh = meshmod.get_mesh(dp=2, shard=2, devices=[CPU] * 4)
    for Kp, k_local in ((352, 192), (512, 256), (8, 8)):
        rows = torch.full((Kp * 256, eng.coords, eng.n), 7, dtype=torch.int16)
        t = tc.ShardedTable(rows, Kp - 1, mesh, curve="bn254_g1")
        assert (t.k_local, t.Kp) == (k_local, 2 * k_local)
        assert all(s.shape == (k_local * 256, eng.coords, eng.n) for row in t.slices for s in row)
        flat = torch.cat([t.slices[0][0], t.slices[0][1]])
        assert torch.equal(flat[: Kp * 256], rows)
        assert all(torch.equal(r, ident) for r in flat[Kp * 256 :])
        assert torch.equal(t.slices[0][1], t.slices[1][1])
        assert torch.equal(t.consts[1][0], torch.from_numpy(eng.consts_np))
    with pytest.raises(ValueError, match="more than one position"):
        tc.ShardedTable(rows, 7, meshmod.get_mesh(dp=1, devices=[CPU]), curve="bn254_g1")


def test_seam_routes_through_the_set_mesh(monkeypatch):
    """Under ``set_mesh`` the seam runs ``msm_many_sharded`` and caches the
    sharded table in its LRU keyed with the mesh; ``cache=False`` keeps it
    out; a mesh of another device type than the entry device raises; a
    one-position mesh takes the single-device route."""
    curve = "bn254_g1"
    pts = _rand_points(curve, random.Random(26), 3)
    rng = random.Random(27)
    vecs = [[rng.randrange(bn.R) for _ in range(3)] for _ in range(3)]
    monkeypatch.setattr(msm_device, "_TABLES", type(msm_device._TABLES)())
    sharded = []
    real = tc.msm_many_sharded

    def counting(table, scalar_vecs, mesh):
        sharded.append(mesh)
        return real(table, scalar_vecs, mesh)

    monkeypatch.setattr(tc, "msm_many_sharded", counting)
    mesh = meshmod.get_mesh(dp=2, shard=2, devices=[CPU] * 4)
    meshmod.set_mesh(mesh)
    out = bn.g1_msm_fixed_many(vecs, pts, device="cpu")
    assert sharded == [mesh]
    assert list(msm_device._TABLES) == [(curve, mesh, tuple(pts))]
    assert isinstance(msm_device._TABLES[(curve, mesh, tuple(pts))], tc.ShardedTable)
    for sv, g in zip(vecs, out):
        assert _same_point(curve, g, bn.g1_msm(sv, pts))
    once = bn.g1_msm_fixed_many(vecs[:1], pts, device="cpu", cache=False)
    assert len(sharded) == 2 and len(msm_device._TABLES) == 1
    assert _same_point(curve, once[0], out[0])
    with pytest.raises(ValueError, match="mesh is on cpu"):
        msm_device._mesh_for(torch.device("cuda"))
    meshmod.set_mesh(meshmod.get_mesh(dp=1, devices=[CPU]))
    single = bn.g1_msm_fixed_many(vecs[:1], pts, device="cpu")
    assert len(sharded) == 2 and _same_point(curve, single[0], out[0])
    assert (curve, "cpu", tuple(pts)) in msm_device._TABLES


def test_seam_default_mesh_and_single_device_pin(monkeypatch):
    """With more than one CUDA device visible the seam's default for a CUDA
    entry device is the mesh over every card; a one-position mesh named by
    ``set_mesh`` pins it to the single-device route on such a host, and a
    CPU entry device never takes the default mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda", 0)
    default = msm_device._mesh_for(cuda)
    assert default.shape == {"dp": 4, "shard": 1} and default.device_type == "cuda"
    assert msm_device._mesh_for(CPU) is None
    meshmod.set_mesh(meshmod.get_mesh(dp=1, devices=[cuda]))
    assert msm_device._mesh_for(cuda) is None


def test_sharded_wrappers_take_cpu_or_cuda_only():
    """A tensor on neither device is refused before any build or launch."""
    for curve in CURVES:
        eng = get_engine(curve)
        consts = torch.empty(eng.consts_np.shape, dtype=torch.int32, device="meta")
        lanes = torch.empty((eng.coords, eng.n, 8), dtype=torch.int32, device="meta")
        pts = torch.empty((8, 5, eng.coords, eng.n), dtype=torch.int16, device="meta")
        for call in (lambda: kernels.tree_sum(consts, pts, curve=curve),
                     lambda: kernels.horner(consts, lanes, lanes, curve=curve)):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                call()
    assert not any(kernels.launches().values())
