"""The port's Montgomery limb engine (``ops/limb.py``) and the ``mont_mul``
kernel's plain version against the JAX package's ``LimbContext``: constants,
codecs and every ring op give the JAX limbs exactly, for BN254 Fr and for
2^255 - 19; the int32 columns of the product never overflow on the programs
that feed it; the kernel library's build digest covers its headers."""

from __future__ import annotations

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import limb as jlimb
from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops import limb as tlimb
from libzkp_tpu_torch.ops.field import BN254_FR

FIELDS = {"bn254_fr": BN254_FR.p, "p25519": ed.P}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ctxs(field):
    p = FIELDS[field]
    return jlimb.get_context(p, field), tlimb.get_context(p, field)


@pytest.mark.parametrize("field", FIELDS)
def test_constants_equal_jax(field):
    jc, tc = _ctxs(field)
    assert (tc.n, tc.ninv, tc.R, tc.R2) == (jc.n, jc.ninv, jc.R, jc.R2) and tc.n == 22
    for name in ("p_limbs", "r2_limbs", "one_mont"):
        np.testing.assert_array_equal(getattr(tc, name), np.asarray(getattr(jc, name)))
    np.testing.assert_array_equal(tc.consts_np[:2], np.stack([tc.p_limbs, tc.one_mont]))
    assert tc.consts_np[2, 0] == tc.ninv and not tc.consts_np[2, 1:].any()


@pytest.mark.parametrize("field", FIELDS)
def test_encode_decode_edges_and_random(field):
    """Edge values round-trip; the vectorised encode gives the limbs of the
    JAX per-value encode."""
    jc, tc = _ctxs(field)
    p = tc.p
    rng = np.random.default_rng(11)
    vals = [0, 1, p - 1, 1 << 253, (1 << 64) - 1, p, p + 5, -3]
    vals += [int.from_bytes(rng.bytes(40), "little") for _ in range(40)]
    enc = tc.encode(vals)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jc.encode(vals)))
    np.testing.assert_array_equal(tc.encode_scalar(p - 1).numpy(), np.asarray(jc.encode_scalar(p - 1)))
    assert tc.decode(enc) == [v % p for v in vals]
    relaxed = rng.integers(-8191, 8192, (30, tc.n), dtype=np.int32)
    assert tc.decode(torch.from_numpy(relaxed)) == jc.decode(jnp.asarray(relaxed))
    assert tlimb._limbs_to_int(relaxed[0]) == jlimb._limbs_to_int(relaxed[0])


OPS = ["add", "sub", "neg", "mont_mul", "to_mont", "from_mont", "reduce", "mont_pow5"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS)
def test_ops_exact_limbs_vs_jax(field, op):
    """Random relaxed inputs (limbs in (-2^13, 2^13)), the JAX limbs exactly,
    and the values mod p of the host's integer arithmetic."""
    jc, tc = _ctxs(field)
    rng = np.random.default_rng(10 * OPS.index(op) + list(FIELDS).index(field))
    a = rng.integers(-8191, 8192, (3, 7, tc.n), dtype=np.int32)
    b = rng.integers(-8191, 8192, (3, 7, tc.n), dtype=np.int32)
    args = (a,) if op in ("neg", "to_mont", "from_mont", "reduce", "mont_pow5") else (a, b)
    got = getattr(tc, op)(*(torch.from_numpy(x) for x in args)).numpy()
    want = np.asarray(getattr(jc, op)(*(jnp.asarray(x) for x in args)))
    np.testing.assert_array_equal(got, want)
    p, rinv = tc.p, pow(tc.R, -1, tc.p)
    av = [tlimb._limbs_to_int(r) for r in a.reshape(-1, tc.n)]
    bv = [tlimb._limbs_to_int(r) for r in b.reshape(-1, tc.n)]
    expect = {
        "add": [x + y for x, y in zip(av, bv)], "sub": [x - y for x, y in zip(av, bv)],
        "neg": [-x for x in av], "mont_mul": [x * y * rinv for x, y in zip(av, bv)],
        "to_mont": [x * tc.R for x in av], "from_mont": [x * rinv for x in av],
        "reduce": av, "mont_pow5": [pow(x * rinv, 5, p) * tc.R for x in av],
    }[op]
    assert tc.decode(torch.from_numpy(got)) == [v % p for v in expect]


def test_mont_mul_broadcasts_b():
    """b broadcasts over a's leading axes (the NTT's twiddles, a one-row
    operand): the limbs of the expanded product."""
    _, tc = _ctxs("bn254_fr")
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-8191, 8192, (4, 3, 5, tc.n), dtype=np.int32))
    w = torch.from_numpy(rng.integers(0, 4096, (3, 5, tc.n), dtype=np.int32))
    one_row = torch.from_numpy(rng.integers(0, 4096, (1, tc.n), dtype=np.int32))
    for b in (w, one_row):
        assert torch.equal(tc.mont_mul(a, b), tc.mont_mul(a, b.expand_as(a).contiguous()))


def test_mont_rows_of_the_paths_shapes():
    """(M, Mb) as the kernel reads them: the twiddles of a stage, a
    one-row operand with or without leading 1s, b = a, and a contiguous
    slice from row 1 (a base 88 bytes past an aligned one)."""
    n = kernels.MONT_N

    def z(*shape):
        return torch.zeros(shape + (n,), dtype=torch.int32)

    a = z(6, 4, 8)
    assert kernels.mont_rows(a, z(4, 8), n) == (192, 32)
    assert kernels.mont_rows(a, z(1, 1, 8), n) == (192, 8)
    assert kernels.mont_rows(a, torch.zeros(n, dtype=torch.int32), n) == (192, 1)
    assert kernels.mont_rows(a, z(1, 1), n) == (192, 1)
    assert kernels.mont_rows(a, a, n) == (192, 192)
    big = z(4097)
    assert big[1:].is_contiguous() and big[1:].data_ptr() % 16 == 8
    assert kernels.mont_rows(big[1:], big[1:], n) == (4096, 4096)


@pytest.mark.parametrize("a_shape, b_shape", [
    ((4, 21), (4, 21)),      # not n limbs
    ((4, 5, 22), (3, 22)),   # b's rows do not divide a's leading axes as a suffix
    ((4, 5, 22), (4, 1, 22)),
    ((5, 22), (2, 5, 22)),   # b longer than a
    ((22,), (2, 22)),
])
def test_mont_rows_raise_on_shapes_the_kernel_cannot_take(a_shape, b_shape):
    a = torch.zeros(a_shape, dtype=torch.int32)
    b = torch.zeros(b_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="suffix"):
        kernels.mont_rows(a, b, kernels.MONT_N)


def test_mont_wrappers_take_cpu_or_cuda_only():
    consts = torch.empty((3, kernels.MONT_N), dtype=torch.int32, device="meta")
    rows = torch.empty((8, kernels.MONT_N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.mont_mul(consts, rows, rows)


# ---------------------------------------------------------------------------
# int32 headroom of the Montgomery product
# ---------------------------------------------------------------------------


class _Headroom:
    """Interval arithmetic over the limb programs, one interval per limb:
    every element of a tensor at a given step of the h pipeline, the MiMC
    batch or the probes lies in the step's intervals (all rows of a step see
    the same operations). ``worst`` is the largest partial sum any int32 of
    the product, an add or a carry pass can hold (a sum of its terms'
    magnitudes, whatever the order of accumulation)."""

    def __init__(self, p: int):
        ctx = tlimb.get_context(p)
        self.n, self.p, self.ninv = ctx.n, [int(v) for v in ctx.p_limbs], ctx.ninv
        self.om = [int(v) for v in ctx.one_mont]
        self.worst = 0
        self.max_in = 0

    def canonical(self):
        return [(0, 4095)] * self.n

    def _note(self, *bounds):
        self.worst = max(self.worst, *bounds)

    def carry(self, x):
        lo = [(l & 4095, h & 4095) if l >> 12 == h >> 12 else (0, 4095) for l, h in x]
        hi = [(l >> 12, h >> 12) for l, h in x]
        w0, w1 = hi[-1]
        out = []
        for i in range(self.n):
            s0, s1 = lo[i]
            if i:
                s0, s1 = s0 + hi[i - 1][0], s1 + hi[i - 1][1]
            s0, s1 = s0 + min(w0 * self.om[i], w1 * self.om[i]), s1 + max(w0 * self.om[i], w1 * self.om[i])
            self._note(4095 + max(abs(v) for v in hi[i - 1]) * (i > 0) + max(abs(w0), abs(w1)) * self.om[i])
            out.append((s0, s1))
        return out

    def add(self, x, y, sign=1):
        if sign < 0:
            y = [(-h, -l) for l, h in y]
        s = [(a + c, b + d) for (a, b), (c, d) in zip(x, y)]
        self._note(*(max(abs(a), abs(b)) for a, b in s))
        return self.carry(s)

    def mm(self, a, b):
        n = self.n
        self.max_in = max(self.max_in, *(max(abs(l), abs(h)) for l, h in a + b))
        T = [[0, 0, 0] for _ in range(2 * n)]  # lo, hi, partial-sum bound
        for j in range(n):
            for i in range(n):
                c = [a[i][0] * b[j][0], a[i][0] * b[j][1], a[i][1] * b[j][0], a[i][1] * b[j][1]]
                t = T[i + j]
                t[0], t[1], t[2] = t[0] + min(c), t[1] + max(c), t[2] + max(abs(v) for v in c)
        for i in range(n):
            for j in range(n):
                t = T[i + j]
                t[1] += 4095 * self.p[j]
                t[2] += 4095 * self.p[j]
            car = (T[i][0] >> 12, T[i][1] >> 12)
            t = T[i + 1]
            t[0], t[1], t[2] = t[0] + car[0], t[1] + car[1], t[2] + max(abs(v) for v in car)
        self._note(*(t[2] for t in T))
        x = [(t[0], t[1]) for t in T[n:]]
        return self.carry(self.carry(self.carry(x)))

    def hull(self, x, y):
        return [(min(a, c), max(b, d)) for (a, b), (c, d) in zip(x, y)]


def _ntt(hr: _Headroom, x, log_n: int, invert: bool):
    can = hr.canonical()
    for s in range(log_n):
        v = hr.mm(x, can)  # twiddles are canonical
        x = hr.hull(hr.add(x, v), hr.add(x, v, -1))
        if s % 4 == 3 and s != log_n - 1:
            x = hr.mm(x, can)  # reduce: R mod p is canonical
    if invert:
        x = hr.mm(x, hr.mm(can, can))  # n^-1, itself to_mont of canonical limbs
    return x


def test_int32_headroom():
    """Every int32 the Montgomery product, its adds and its carry passes hold
    stays below 2^31 in magnitude (signed overflow is undefined in the CUDA
    kernel): the h pipeline at n = 512 and the 110 MiMC rounds over BN254
    Fr, the P6 probe's random limbs and the P7 Edwards addition over
    2^255 - 19, and every row P7's kernel stores as int16 fits it. Computed
    in Python ints, so nothing here can overflow."""
    hr = _Headroom(BN254_FR.p)
    can = hr.canonical()
    one = [(1, 1)] + [(0, 0)] * (hr.n - 1)
    xm = hr.mm(can, can)                          # to_mont
    coeffs = _ntt(hr, xm, 9, True)
    on_coset = _ntt(hr, hr.mm(coeffs, can), 9, False)
    h_ev = hr.mm(hr.add(hr.mm(on_coset, on_coset), on_coset, -1), can)
    h = hr.mm(_ntt(hr, h_ev, 9, True), can)
    hr.mm(h, one)                                 # from_mont
    x = hr.mm(can, can)
    for _ in range(110):                          # MiMC: add, then mont_pow5
        t = hr.add(x, can)
        t2 = hr.mm(t, t)
        x = hr.mm(hr.mm(t2, t2), t)
    hr.mm(x, one)
    assert hr.worst < 2**31, hr.worst
    assert hr.max_in < 2**14

    ed_hr = _Headroom(ed.P)
    rnd = [(-4096, 4095)] * ed_hr.n               # P6's operands
    ed_hr.mm(rnd, rnd)
    c = ed_hr.canonical()                         # P7: Montgomery coordinates
    A = ed_hr.mm(ed_hr.add(c, c, -1), ed_hr.add(c, c, -1))
    B = ed_hr.mm(ed_hr.add(c, c), ed_hr.add(c, c))
    C = ed_hr.mm(ed_hr.mm(c, c), c)
    zz = ed_hr.mm(c, c)
    D = ed_hr.add(zz, zz)
    E, F, G, H = ed_hr.add(B, A, -1), ed_hr.add(D, C, -1), ed_hr.add(D, C), ed_hr.add(B, A)
    for u, v in ((E, F), (G, H), (F, G), (E, H)):
        ed_hr.mm(u, v)
    assert ed_hr.worst < 2**31, ed_hr.worst
    # P7's kernel holds a lane's rows as int16: the inputs, Y -/+ X of both
    # points, A, B, T1 T2, C, D, then E, H, F, G; every limb fits
    stored = [c, ed_hr.add(c, c, -1), ed_hr.add(c, c), A, B, ed_hr.mm(c, c), C, D, E, F, G, H]
    assert all(-(1 << 15) <= lo and hi < (1 << 15) for row in stored for lo, hi in row)


def test_library_digest_covers_every_header(tmp_path, monkeypatch):
    """A kernel library's build name changes when its source or any header
    it includes changes, and only then: an edited header is never served a
    stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {lib: kernels._library_path(lib) for lib in kernels.LIBRARIES}
    assert kernels._sources("probes") == ["probes.cu", "bn254_fq.cuh", "coop_horner.cuh", "mont.cuh",
                                          "fold_curves.cuh", "coop_sum.cuh"]
    assert kernels._sources("mont") == ["mont.cu", "mont.cuh"]
    for header in ("fold_curves.cuh", "mont.cuh", "bn254_fq.cuh"):
        path = csrc / header
        original = path.read_bytes()
        path.write_bytes(original + b"// edited\n")
        after = {lib: kernels._library_path(lib) for lib in kernels.LIBRARIES}
        changed = {lib for lib in kernels.LIBRARIES if after[lib] != before[lib]}
        assert changed == {lib for lib in kernels.LIBRARIES if header in kernels._sources(lib)}
        path.write_bytes(original)
    assert {lib: kernels._library_path(lib) for lib in kernels.LIBRARIES} == before
