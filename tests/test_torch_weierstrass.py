"""The port's BN254 G1/G2 point engines, the plain versions of the grouped
window-sum and Horner kernels, the G1/G2 table build, the v4 MSM and the MSM
seam against the JAX package and the host golden tier; and the int32
headroom argument of ``csrc/fold_curves.cuh`` for p = BN254 Fq.

The JAX side runs as its own tests run it on the CPU: each Pallas factory
returns its jnp branch. Limbs must be identical wherever the operation order
is the same; MSM results must equal the host golden values.
"""

from __future__ import annotations

import importlib.util
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import curve_jax as cj
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.ops import curve as tc
from libzkp_tpu_torch.ops import kernels, msm_device
from libzkp_tpu_torch.ops.weierstrass import get_engine

CURVES = ("bn254_g1", "bn254_g2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_points(curve, rng, k):
    if curve == "bn254_g1":
        g = bn.g1_from_affine(bn.G1_GEN)
        return [bn.g1_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(k)]
    g = bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y))
    return [bn.g2_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(k)]


def _lanes(enc):
    """(B, C, n) -> (C, n, B)."""
    return np.ascontiguousarray(np.transpose(enc, (1, 2, 0)))


def _add(curve):
    return bn.g1_add if curve == "bn254_g1" else bn.g2_add


def _affine(curve, p):
    return bn.g1_to_affine(p) if curve == "bn254_g1" else bn.g2_to_affine(p)


def _jax_engine(curve):
    return cj.bn254_g1_engine() if curve == "bn254_g1" else cj.bn254_g2_engine()


@pytest.fixture(scope="module", params=CURVES)
def curve_case(request):
    """Engines, consts, a 6-point basis, its JAX table (host-built, Kp = 8)
    and the port's table (plain table-add chain)."""
    curve = request.param
    ej, et = _jax_engine(curve), get_engine(curve)
    assert (ej.consts_np == et.consts_np).all()
    pts = _rand_points(curve, random.Random(11), 6)
    base = et.encode_points(pts)
    jt = (cj.build_table_bn254_g1 if curve == "bn254_g1" else cj.build_table_bn254_g2)(pts)
    ours = tc.DeviceTable(base, device="cpu", curve=curve)
    return dict(curve=curve, ej=ej, et=et, jc=jnp.asarray(ej.consts_np),
                ct=torch.from_numpy(et.consts_np), pts=pts, base=base, jt=jt, ours=ours)


def test_padd_pdouble_limbs_and_identities(curve_case):
    c = curve_case
    curve, ej, et, jc, ct, pts = (c[k] for k in ("curve", "ej", "et", "jc", "ct", "pts"))
    qts = pts[1:] + pts[:1]
    P, Q = _lanes(et.encode_points(pts)), _lanes(et.encode_points(qts))
    got = et.padd(ct, torch.from_numpy(P), torch.from_numpy(Q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ej.padd(jc, jnp.asarray(P), jnp.asarray(Q))))
    # relaxed inputs: double the sums
    dbl = et.pdouble(ct, got)
    np.testing.assert_array_equal(dbl.numpy(), np.asarray(ej.pdouble(jc, jnp.asarray(got.numpy()))))
    add = _add(curve)
    decoded = et.decode_points(np.transpose(got.numpy(), (2, 0, 1)))
    for i in range(len(pts)):
        assert _affine(curve, decoded[i]) == _affine(curve, add(pts[i], qts[i]))
    # complete law: P + P == 2P, P + identity == P, identity + identity
    Pt = torch.from_numpy(P)
    ident = et.identity(len(pts), "cpu")
    for out, want in (
        (et.padd(ct, Pt, Pt), [add(p, p) for p in pts]),
        (et.padd(ct, Pt, ident), pts),
    ):
        for g, w in zip(et.decode_points(np.transpose(out.numpy(), (2, 0, 1))), want):
            assert _affine(curve, g) == _affine(curve, w)
    inf = et.decode_points(np.transpose(et.padd(ct, ident, ident).numpy(), (2, 0, 1)))
    assert all(_affine(curve, p) is None for p in inf)


def test_table_build_matches_jax_limbs(curve_case):
    """The port's plain table-add chain against the JAX eager chain on the
    same padded basis: identical int16 limbs."""
    c = curve_case
    ours = c["ours"]
    assert (ours.K, ours.Kp) == (6, 8) and ours.table.dtype == torch.int16
    padded = np.concatenate(
        [c["base"], np.broadcast_to(c["ej"].identity_np()[None], (2, c["et"].coords, c["et"].n))]
    )
    theirs = np.asarray(cj._table_build_jit(c["curve"], 8)(c["jc"], jnp.asarray(padded)))
    np.testing.assert_array_equal(ours.table.numpy(), theirs)


@pytest.mark.parametrize("B", [8, 16])
def test_window_sum4_plain_matches_jax(curve_case, B):
    """Fed the JAX table (through convert.multiples_table) and the same
    (4, Kp, B) digits, the plain window_sum4 gives the JAX
    _window_fused4_call CPU branch's limbs, lane w*B + b."""
    c = curve_case
    jt = c["jt"]
    dig = np.random.default_rng(B).integers(0, 256, size=(kernels.WIN_GROUP, jt.Kp, B)).astype(np.int32)
    want = np.asarray(cj._window_fused4_call(c["curve"], jt.Kp, B)(
        c["jc"], jt.table_int8_packed, jnp.asarray(dig)))
    table = convert.multiples_table(np.asarray(jt.table), 6, device="cpu", curve=c["curve"])
    got = kernels.window_sum4(c["ct"], table.table, torch.from_numpy(dig), curve=c["curve"])
    assert got.shape == (c["et"].coords, c["et"].n, kernels.WIN_GROUP * B)
    np.testing.assert_array_equal(got.numpy(), want)


def test_horner4_and_pair_add_plain_match_jax(curve_case):
    c = curve_case
    ours, ct, jc = c["ours"], c["ct"], c["jc"]
    rows = ours.table.view(ours.Kp, 256, c["et"].coords, -1)
    acc = rows[:, 77].permute(1, 2, 0).to(torch.int32).contiguous()  # (C, n, 8)
    wsums = torch.cat([rows[:, d].permute(1, 2, 0) for d in (201, 3, 255, 128)], -1)
    wsums = wsums.to(torch.int32).contiguous()  # (C, n, 32)
    want = np.asarray(cj._horner4_call(c["curve"], ours.Kp)(
        jc, jnp.asarray(acc.numpy()), jnp.asarray(wsums.numpy())))
    np.testing.assert_array_equal(kernels.horner4(ct, acc, wsums, curve=c["curve"]).numpy(), want)
    q = wsums[..., : ours.Kp].contiguous()
    want = np.asarray(cj._pair_add_call(c["curve"], ours.Kp)(jc, jnp.asarray(acc.numpy()),
                                                             jnp.asarray(q.numpy())))
    np.testing.assert_array_equal(kernels.pair_add(ct, acc, q, curve=c["curve"]).numpy(), want)
    assert not any(kernels.launches().values())


def test_msm_matches_host(curve_case):
    """The v4 MSM over the port's table against the host Pippenger MSM."""
    c = curve_case
    curve, pts, ours = c["curve"], c["pts"], c["ours"]
    rng = random.Random(7)
    vecs = [[rng.randrange(bn.R) for _ in range(6)] for _ in range(5)]
    vecs[0] = [0] * 6  # all-zero vector -> identity
    vecs[1][3] = 0
    vecs[2] = [bn.R - 1] * 6
    host_msm = bn.g1_msm if curve == "bn254_g1" else bn.g2_msm
    for sv, g in zip(vecs, tc.msm_many(ours, vecs)):
        assert _affine(curve, g) == _affine(curve, host_msm(sv, pts))


def test_seam_chunks_and_caches_tables(monkeypatch):
    """msm_fixed_many: one table per basis value (reused for an equal list),
    batches cut into power-of-two padded chunks, host results; with
    ``cache=False`` a table built for the call alone, outside the LRU."""
    curve = "bn254_g1"
    pts = _rand_points(curve, random.Random(5), 3)
    rng = random.Random(6)
    vecs = [[rng.randrange(bn.R) for _ in range(3)] for _ in range(7)]
    monkeypatch.setattr(msm_device, "CHUNK_B", 4)
    built = []
    real = tc.DeviceTable

    def counting(*args, **kwargs):
        built.append(kwargs["curve"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tc, "DeviceTable", counting)
    monkeypatch.setattr(msm_device, "_TABLES", type(msm_device._TABLES)())
    out = bn.g1_msm_fixed_many(vecs, pts, device="cpu")
    again = bn.g1_msm_fixed_many(vecs[:2], list(pts), device="cpu")
    assert built == [curve]
    for sv, g in zip(vecs, out):
        assert _affine(curve, g) == _affine(curve, bn.g1_msm(sv, pts))
    assert [_affine(curve, g) for g in again] == [_affine(curve, g) for g in out[:2]]
    keys = list(msm_device._TABLES)
    once = bn.g1_msm_fixed_many(vecs[:2], pts, device="cpu", cache=False)
    assert built == [curve, curve] and list(msm_device._TABLES) == keys
    assert [_affine(curve, g) for g in once] == [_affine(curve, g) for g in out[:2]]
    assert bn.g2_msm_fixed_many([], [], device="cpu") == []


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("curve", ("ed25519",) + CURVES)
def test_chip_smoke_point_check_rejects_unwritten_lanes(curve):
    """The check that holds the window-sum kernels against their plain
    versions by projective equality: 0 for the same points in other
    representatives; nonzero for a lane zeroed on one side or on both (a
    zero lane passes every cross-product) and for another point."""
    smoke = _chip_smoke()
    rng = random.Random(31)
    if curve == "ed25519":
        from libzkp_tpu_torch.ops import ed25519 as ed

        eng = tc.edwards_engine()
        pts = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(4)]
        check = smoke._edwards_point_err
    else:
        eng = get_engine(curve)
        pts = _rand_points(curve, rng, 4)
        check = lambda a, b: smoke._weierstrass_point_err(curve, a, b)  # noqa: E731
    consts = torch.from_numpy(eng.consts_np)
    a = torch.from_numpy(_lanes(eng.encode_points(pts)))
    rescaled = eng.padd(consts, a, eng.identity(4, "cpu"))  # same points, other limbs
    assert not torch.equal(rescaled, a)
    assert check(a, rescaled) == 0
    zeroed = rescaled.clone()
    zeroed[..., 2] = 0
    assert check(a, zeroed) != 0
    both = a.clone()
    both[..., 2] = 0
    assert check(both, zeroed) != 0
    assert check(a, a.roll(1, dims=-1)) != 0


def test_bn254_wrappers_take_cpu_or_cuda_only():
    """A tensor on neither device is refused before any build or launch."""
    for curve in CURVES:
        eng = get_engine(curve)
        consts = torch.empty(eng.consts_np.shape, dtype=torch.int32, device="meta")
        pts = torch.empty((eng.coords, eng.n, 8), dtype=torch.int32, device="meta")
        wide = torch.empty((eng.coords, eng.n, 32), dtype=torch.int32, device="meta")
        table = torch.empty((32 * 256, eng.coords, eng.n), dtype=torch.int16, device="meta")
        digits = torch.empty((4, 32, 8), dtype=torch.int32, device="meta")
        for call in (
            lambda: kernels.window_sum4(consts, table, digits, curve=curve),
            lambda: kernels.horner4(consts, pts, wide, curve=curve),
            lambda: kernels.pair_add(consts, pts, pts, curve=curve),
        ):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                call()
    assert not any(kernels.launches().values())


# ---------------------------------------------------------------------------
# int32 headroom of the fold field at p = BN254 Fq (csrc/fold_curves.cuh)
# ---------------------------------------------------------------------------

_LIM = 1 << 31
_MASK = 4095


class _Iv:
    """Per-limb integer intervals [lo, hi] of a field element."""

    def __init__(self, lo, hi):
        self.lo = np.asarray(lo, np.int64)
        self.hi = np.asarray(hi, np.int64)


class _IntervalField:
    """The fold field's add, sub, small multiply, carry and product, on
    per-limb intervals, asserting that every intermediate of the int32
    schedule (raw sums, conv columns as the sum of their terms' magnitudes,
    fold rows, carries) stays below 2^31; ``peak`` keeps the largest."""

    def __init__(self, ctx):
        self.n = ctx.n
        self.one = ctx.ONE.astype(np.int64)
        self.fold = ctx.FOLD.astype(np.int64)
        self.peak = 0

    def _chk(self, *mags):
        m = int(max(np.max(x) for x in mags))
        assert m < _LIM, m
        self.peak = max(self.peak, m)

    def raw(self, lo, hi):
        self._chk(np.abs(lo), np.abs(hi))
        return _Iv(lo, hi)

    def carry(self, a):
        slo, shi = a.lo >> 12, a.hi >> 12
        c1, c2 = slo[-1] * self.one, shi[-1] * self.one
        lo, hi = np.minimum(c1, c2), np.maximum(c1, c2) + _MASK
        lo[1:] += slo[:-1]
        hi[1:] += shi[:-1]
        return self.raw(lo, hi)

    def add(self, a, b):
        return self.carry(self.raw(a.lo + b.lo, a.hi + b.hi))

    def sub(self, a, b):
        return self.carry(self.raw(a.lo - b.hi, a.hi - b.lo))

    def triple(self, a):
        return self.carry(self.raw(3 * a.lo, 3 * a.hi))

    def smul(self, a, k):
        return self.carry(self.carry(self.raw(k * a.lo, k * a.hi)))

    def _nowrap(self, lo, hi):
        slo, shi = lo >> 12, hi >> 12
        lo2, hi2 = np.zeros_like(lo), np.full_like(hi, _MASK)
        lo2[1:] += slo[:-1]
        hi2[1:] += shi[:-1]
        return lo2, hi2

    def mul(self, a, b):
        n = self.n
        corners = np.stack([np.outer(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)])
        lo_t, hi_t, mag_t = corners.min(0), corners.max(0), np.abs(corners).max(0)
        cols = 2 * n + 2
        lo, hi, mag = (np.zeros(cols, np.int64) for _ in range(3))
        for i in range(n):
            lo[i : i + n] += lo_t[i]
            hi[i : i + n] += hi_t[i]
            mag[i : i + n] += mag_t[i]
        self._chk(mag)
        lo, hi = self._nowrap(*self._nowrap(lo, hi))
        c1, c2 = lo[n:, None] * self.fold, hi[n:, None] * self.fold
        flo = lo[:n] + np.minimum(c1, c2).sum(0)
        fhi = hi[:n] + np.maximum(c1, c2).sum(0)
        self._chk(np.maximum(np.abs(lo[:n]), np.abs(hi[:n])) + np.maximum(abs(c1), abs(c2)).sum(0))
        r = _Iv(flo, fhi)
        for _ in range(3):
            r = self.carry(r)
        return r


def _rcb_padd_intervals(F, eng, P, Q):
    """RCB algorithm 7 on intervals, operation for operation as
    WeierstrassEngine.padd (and the cooperative padds of csrc/coop_sum.cuh)."""
    r = eng.rows

    def mul(a, b):
        if r == 1:
            return [F.mul(a[0], b[0])]
        m0, m1 = F.mul(a[0], b[0]), F.mul(a[1], b[1])
        t = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        return [F.sub(m0, m1), F.sub(F.sub(t, m0), m1)]

    def mul_b3(x):
        if r == 1:
            return [F.smul(x[0], eng.b3_small)]
        rows = eng.consts_np[F.n + 3 : F.n + 5]  # b3.c0, b3.c1
        return mul(x, [_Iv(row, row) for row in rows])

    def add(a, b):
        return [F.add(x, y) for x, y in zip(a, b)]

    def sub(a, b):
        return [F.sub(x, y) for x, y in zip(a, b)]

    X1, Y1, Z1 = P[:r], P[r : 2 * r], P[2 * r :]
    X2, Y2, Z2 = Q[:r], Q[r : 2 * r], Q[2 * r :]
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))
    t4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))
    X3 = mul(add(X1, Z1), add(X2, Z2))
    Y3 = sub(X3, add(t0, t2))
    X3 = [F.triple(x) for x in t0]
    t2 = mul_b3(t2)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    Y3 = mul_b3(Y3)
    return (sub(mul(t3, t1), mul(t4, Y3)) + add(mul(t1, Z3), mul(Y3, X3))
            + add(mul(Z3, t4), mul(X3, t3)))


@pytest.mark.parametrize("curve", CURVES)
def test_int32_headroom(curve):
    """From canonical limbs [0, 4095], padd's output limbs reach a fixed
    interval closed under padd, and no intermediate of the int32 schedule
    reaches 2^31 on the way: the no-overflow argument the CUDA header states
    for p = BN254 Fq (its numbers are checked here)."""
    eng = get_engine(curve)
    F = _IntervalField(eng.ctx)
    iv = _Iv(np.zeros(F.n, np.int64), np.full(F.n, _MASK, np.int64))
    for _ in range(10):
        outs = _rcb_padd_intervals(F, eng, [iv] * eng.coords, [iv] * eng.coords)
        lo = np.minimum(iv.lo, np.min([o.lo for o in outs], 0))
        hi = np.maximum(iv.hi, np.max([o.hi for o in outs], 0))
        if (lo == iv.lo).all() and (hi == iv.hi).all():
            break
        iv = _Iv(lo, hi)
    else:
        raise AssertionError("limb intervals did not close under padd")
    assert (int(iv.lo.min()), int(iv.hi.max())) == (-7643 if curve == "bn254_g2" else -7642, 11737)
    assert -(1 << 15) <= iv.lo.min() and iv.hi.max() < (1 << 15)  # int16 table rows
    assert F.peak < 2 ** 30.31
