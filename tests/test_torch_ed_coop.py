"""The ed25519 window sum's and Horner step's design (``csrc/coop_sum.cuh``
``EdCoop``, ``csrc/coop_horner.cuh``) on the CPU.

The CUDA kernels run only on the card; what they compute is held here at
small sizes against the plain versions:

* the four-thread padd's and pdouble's schedules (round 1 with thread 2's
  2d product and thread 3's doubling of Z1 Z2, or thread 2's doubling of
  Z^2; then the operands E, F, G, H built from the scratch rows, each by the
  two threads that need it, and the four output products) give the limbs of
  the plain ``EdwardsEngine.padd`` and ``pdouble``;
* the halving tree on that schedule, every level narrowed to int16 as the
  kernel's level store holds it, over rows gathered by digits from a real
  multiples table, gives ``window_sum_plain``'s limbs (and so the JAX
  ``_window_fused_call``'s, tests/test_torch_curve.py), and over lane-major
  rows gathered from the range basis's table, as the mesh's ``tree_sum``
  reads them, ``tree_sum_plain``'s (and so the JAX ``_window_sum_call``'s,
  tests/test_torch_sharded_msm.py);
* the Horner chain on those schedules (``coop_horner_kernel<EdCoop, 1,
  8>``: 8 pdoubles and one padd), the accumulator and the window sum
  narrowed to int16 once and every step's output as the kernel's shared
  memory holds it, gives ``horner_plain``'s limbs (and so the JAX
  ``_horner_call``'s, tests/test_torch_curve.py);
* P2's chain (``coop_chain_kernel<EdCoop>``): p and q narrowed to int16
  once, then 64 cooperative padds in place, gives ``padd_chain_plain``'s
  limbs (and so a loop of the JAX ``EdwardsEngine.padd``'s,
  tests/test_torch_probes.py), every step inside [-1536, 5631];
* the table-add step on the padd (``coop_horner_kernel<EdCoop, 1, 0>``:
  one padd), p and q narrowed to int16 once, gives ``pair_add_plain``'s
  limbs (and so the JAX ``_pair_add_call``'s, tests/test_torch_curve.py)
  over the range basis's 255-step table build, the mesh fold's partial
  sums, P5's inputs, a doubling and the identity on either side;
* the kernels' product (``ed_mul``: p = 2^255 - 19's ONE and FOLD limbs
  written into the code, zeros left out) uses exactly the nonzero limbs of
  the consts block, and its sums give the fold product's limbs;
* interval arithmetic over padd and pdouble at p = 2^255 - 19 pins the
  output interval the header states, inside int16 and int32 headroom;
* the wrappers' launch geometry at the range prover's lane counts.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch
from test_torch_weierstrass import _MASK, _IntervalField, _Iv

from libzkp_tpu_torch import probes
from libzkp_tpu_torch.models import bp_device
from libzkp_tpu_torch.ops import curve as tc
from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops.limbfold import FieldOps

CURVE = "ed25519"
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ed_table():
    """Consts and the (Kp * 256, 4, n) int16 multiples table of 6 random
    Ristretto points (Kp = 8), built by the plain table-add chain."""
    eng = tc.edwards_engine()
    rng = random.Random(9)
    pts = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(6)]
    table = tc.DeviceTable(eng.encode_points(pts), device="cpu")
    return torch.from_numpy(eng.consts_np), table.table, table.Kp


@pytest.fixture(scope="module")
def range_table():
    """Consts and the (Kp * 256, 4, n) int16 multiples table of the range
    prover's first 8 basis points (B_blinding, G_0 .. G_6)."""
    eng = tc.edwards_engine()
    table = tc.DeviceTable(eng.encode_points(bp_device._basis_points(64)[:8]), device="cpu")
    return torch.from_numpy(eng.consts_np), table.table, table.Kp


def _basis(table, kp: int, K: int) -> torch.Tensor:
    """A (K * 256, 4, n) table whose basis point k is the fixture's k % kp."""
    n = table.shape[-1]
    return table.view(kp, 256, 4, n)[torch.arange(K) % kp].reshape(K * 256, 4, n)


def _digits(K: int, lanes: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (K, lanes)).astype(np.int32))


def _lanes(rows: torch.Tensor) -> torch.Tensor:
    """(L, 4, n) int16 rows -> (4, n, L) int32 points."""
    return rows.to(torch.int32).permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------------------
# ed_mul (csrc/coop_sum.cuh): the fold product with the nonzero constants
# ---------------------------------------------------------------------------

ONE_LIMBS = {2: 1536, 3: 2}  # ed_carry's wrap constant


def _fold_limbs(k: int) -> dict:
    """ed_mul's nonzero limbs of FOLD row k."""
    return {2 + k: 1536, 3 + k: 2} if k < 19 else {k - 19: 2624, k - 18: 5}


def _ed_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ed_mul's sums on (n, L) int32: the convolution, two no-wrap passes,
    the fold over the nonzero limbs only, three wrap carries over ONE's."""
    n = a.shape[0]
    T = torch.zeros((2 * n + 2, a.shape[1]), dtype=torch.int32)
    for i in range(n):
        T[i : i + n] += a[i] * b
    for _ in range(2):
        hi = T >> 12
        T = T & 4095
        T[1:] += hi[:-1]
    r = T[:n].clone()
    for k in range(n + 2):
        for i, c in _fold_limbs(k).items():
            r[i] += T[n + k] * c
    for _ in range(3):
        top, hi = r[-1] >> 12, r >> 12
        r = r & 4095
        r[1:] += hi[:-1]
        for i, c in ONE_LIMBS.items():
            r[i] += top * c
    return r


def test_ed_mul_constants_are_the_nonzero_fold_limbs():
    ctx = tc.edwards_engine().ctx
    assert {i: int(v) for i, v in enumerate(ctx.ONE) if v} == ONE_LIMBS
    for k, row in enumerate(ctx.FOLD):
        assert {i: int(v) for i, v in enumerate(row) if v} == _fold_limbs(k)
    assert sum(len(_fold_limbs(k)) for k in range(ctx.n + 2)) == 52


def test_ed_mul_sums_give_fold_product_limbs(ed_table):
    """Canonical limbs, limbs across the interval the kernels see, table
    rows and the identity: ed_mul's sums equal FieldOps.mul's limbs."""
    consts, table, kp = ed_table
    n = tc.edwards_engine().n
    rng = np.random.default_rng(3)
    a = [rng.integers(0, 4096, (n, 64)), rng.integers(-1536, 5632, (n, 64)),
         _lanes(table[torch.arange(64) * 7 % (kp * 256)]).reshape(4 * n, 64)[:n].numpy()]
    b = [rng.integers(0, 4096, (n, 64)), rng.integers(-1536, 5632, (n, 64)),
         tc.edwards_engine().identity(64, "cpu")[1].numpy()]
    f = FieldOps(n, consts)
    for x in a:
        for y in b:
            x_t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
            y_t = torch.from_numpy(np.ascontiguousarray(y, dtype=np.int32))
            assert torch.equal(_ed_mul(x_t, y_t), f.mul(x_t, y_t))


# ---------------------------------------------------------------------------
# the four-thread schedules (csrc/coop_sum.cuh ed_padd_coop, ed_pdouble_coop)
# ---------------------------------------------------------------------------

A_ROWS, B_ROWS = 0x0120, 0x3231  # thread g's operands: E F, G H, F G, E H


def _coop_padd(f: FieldOps, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """ed_padd_coop row by row: P, Q (4, n, L) int32 -> P + Q (4, n, L)."""
    rows = []
    for g in range(4):  # round 1, thread g, in registers; then its row
        if g < 2:
            sign = 1 if g else -1
            a, b = f.carry(P[1] + sign * P[0]), f.carry(Q[1] + sign * Q[0])
        else:
            a, b = P[3 if g == 2 else 2], Q[3 if g == 2 else 2]
        r = f.mul(a, b)
        if g == 2:
            r = f.mul(r, f.extra_const(0))
        elif g == 3:
            r = f.carry(r + r)
        rows.append(r)  # A, B, C, D

    def operand(v):  # E, F, G, H (ed_padd_row)
        base = 2 if v in (1, 2) else 0
        return f.carry(rows[base + 1] + (1 if v >= 2 else -1) * rows[base])

    return torch.stack([f.mul(operand((A_ROWS >> 4 * g) & 15), operand((B_ROWS >> 4 * g) & 15))
                        for g in range(4)])


def _coop_pdouble(f: FieldOps, P: torch.Tensor) -> torch.Tensor:
    """ed_pdouble_coop row by row: P (4, n, L) int32 -> 2P (4, n, L)."""
    rows = []
    for g in range(4):
        a = P[g] if g < 3 else f.carry(P[0] + P[1])
        r = f.mul(a, a)
        rows.append(f.carry(r + r) if g == 2 else r)  # A, B, C, (X + Y)^2

    def operand(v):  # E, F, G, H (ed_pdouble_row)
        r = f.carry(rows[0] + (1 if v in (0, 3) else -1) * rows[1])  # H or G
        if v < 2:
            r = f.carry(r + (-1 if v == 0 else 1) * rows[3 if v == 0 else 2])
        return r

    return torch.stack([f.mul(operand((A_ROWS >> 4 * g) & 15), operand((B_ROWS >> 4 * g) & 15))
                        for g in range(4)])


def _operands(table, kp: int, lanes: int, seed: int):
    """P, Q (4, n, lanes): distinct table rows, with a doubling (lane 0),
    the identity as Q (lane 1) and as P (lane 2)."""
    eng = tc.edwards_engine()
    d = _digits(2, lanes, seed)
    P = _lanes(table[torch.arange(lanes) % kp * 256 + d[0]])
    Q = _lanes(table[(torch.arange(lanes) + 3) % kp * 256 + d[1]])
    Q[..., 0] = P[..., 0]
    Q[..., 1] = eng.identity(1, "cpu")[..., 0]
    P[..., 2] = eng.identity(1, "cpu")[..., 0]
    return P, Q


def test_cooperative_ed_padd_schedule_gives_padd_limbs(ed_table):
    """Distinct points, a doubling, the identity on either side, and padd
    outputs fed back three times: every limb equals the plain padd's."""
    consts, table, kp = ed_table
    eng = tc.edwards_engine()
    f = FieldOps(eng.n, consts)
    P, Q = _operands(table, kp, 16, seed=1)
    for _ in range(4):
        want = eng.padd(consts, P, Q)
        assert torch.equal(_coop_padd(f, P, Q), want)
        P, Q = want, P


def test_cooperative_ed_pdouble_schedule_gives_pdouble_limbs(ed_table):
    """Table rows, the identity, and pdouble and padd outputs fed back three
    times: every limb equals the plain pdouble's."""
    consts, table, kp = ed_table
    eng = tc.edwards_engine()
    f = FieldOps(eng.n, consts)
    P, Q = _operands(table, kp, 16, seed=2)
    P[..., 3] = eng.identity(1, "cpu")[..., 0]
    for _ in range(4):
        want = eng.pdouble(consts, P)
        assert torch.equal(_coop_pdouble(f, P), want)
        P = eng.padd(consts, want, Q)


# ---------------------------------------------------------------------------
# the narrowed halving tree (coop_tree_sum<EdCoop>, window_sum.cu)
# ---------------------------------------------------------------------------


def _narrowed(x: torch.Tensor) -> torch.Tensor:
    n16 = x.to(torch.int16)
    assert torch.equal(n16.to(torch.int32), x), "a limb left int16"
    return n16


def _narrowed_tree(f: FieldOps, v: torch.Tensor) -> torch.Tensor:
    """coop_tree_sum's order and storage: level 1 from the (K, B, 4, n)
    int16 rows, every level's outputs (and the carried odd point) narrowed
    to int16 in the level store, the last one widened. -> (4, n, B)."""
    B, n = v.shape[1], v.shape[-1]
    while v.shape[0] > 1:
        K, half = v.shape[0], v.shape[0] // 2

        def lanes(x):  # (half, B, 4, n) -> (4, n, half * B)
            return x.to(torch.int32).permute(2, 3, 0, 1).reshape(4, n, half * B)

        s = _coop_padd(f, lanes(v[:half]), lanes(v[half : 2 * half]))
        s = _narrowed(s.reshape(4, n, half, B).permute(2, 3, 0, 1))
        v = torch.cat([s, v[-1:]]) if K % 2 else s
    return v[0].to(torch.int32).permute(1, 2, 0)


def _narrowed_window_sum(f: FieldOps, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """window_sum_kernel: the tree over the table rows at k * 256 +
    digit[k, b]. (Kp, B) digits -> (4, n, B)."""
    K = digits.shape[0]
    return _narrowed_tree(f, table[torch.arange(K)[:, None] * 256 + digits.to(torch.int64)])


@pytest.mark.parametrize("K", [1, 2, 3, 33, 96, 160])
def test_narrowed_ed_tree_gives_window_sum_plain_limbs(ed_table, K):
    consts, table, kp = ed_table
    basis = _basis(table, kp, K)
    digits = _digits(K, 3, seed=K)
    got = _narrowed_window_sum(FieldOps(tc.edwards_engine().n, consts), basis, digits)
    assert got.shape == (4, tc.edwards_engine().n, 3)
    assert torch.equal(got, kernels.window_sum_plain(consts, basis, digits))


@pytest.mark.parametrize("K", [1, 2, 3, 33, 96])
def test_narrowed_ed_tree_gives_tree_sum_plain_limbs(range_table, K):
    """tree_sum ed25519 (tree_sum_coop_kernel<EdCoop>): the tree over each
    lane's rows as the mesh's window walk gathers them (``_gather``:
    lane-major (B, K, 4, n) int16, basis point k the range basis's k % 8),
    at K up to the range basis's k_local at shard 2 (96)."""
    consts, table, kp = range_table
    basis = _basis(table, kp, K)
    pts = kernels._gather(basis, _digits(K, 5, seed=100 + K))
    assert pts.shape == (5, K, 4, tc.edwards_engine().n) and pts.dtype == torch.int16
    got = _narrowed_tree(FieldOps(tc.edwards_engine().n, consts), pts.transpose(0, 1))
    assert torch.equal(got, kernels.tree_sum_plain(consts, pts, curve="ed25519"))


# ---------------------------------------------------------------------------
# the narrowed Horner chain (coop_horner_kernel<EdCoop, 1, 8>, horner.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 7, 8, 9])
def test_narrowed_ed_horner_chain_gives_horner_plain_limbs(ed_table, B):
    """The accumulator and the window sum narrowed to int16 once, then 8
    cooperative pdoubles and one cooperative padd, the accumulator narrowed
    after every step. Lane 0 starts from the identity (the MSM's first
    window), lane 1 from an earlier chain output, the others from window
    sums (K1 outputs, as the window walk's wsum); every intermediate fits
    int16 and the limbs equal horner_plain's."""
    consts, table, kp = ed_table
    eng = tc.edwards_engine()
    f = FieldOps(eng.n, consts)
    basis = _basis(table, kp, 33)
    sums = kernels.window_sum_plain(consts, basis, _digits(33, 2 * B + 1, seed=70 + B))
    acc0 = sums[..., :B].clone()
    acc0[..., 0] = eng.identity(1, "cpu")[..., 0]
    wsum = sums[..., B : 2 * B].contiguous()
    if B > 1:
        acc0[..., 1] = kernels.horner_plain(consts, sums[..., 2 * B :], sums[..., :1])[..., 0]

    acc = _narrowed(acc0).to(torch.int32)
    w = _narrowed(wsum).to(torch.int32)
    for _ in range(8):
        acc = _narrowed(_coop_pdouble(f, acc)).to(torch.int32)
    acc = _narrowed(_coop_padd(f, acc, w)).to(torch.int32)
    assert torch.equal(acc, kernels.horner_plain(consts, acc0, wsum))


# ---------------------------------------------------------------------------
# the narrowed pair_add (coop_horner_kernel<EdCoop, 1, 0>, pair_add.cu)
# ---------------------------------------------------------------------------


def _narrowed_pair_add(f: FieldOps, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K3's kernel: p and q narrowed to int16 once, one cooperative padd,
    its output as the kernel's shared memory holds it (int16), widened."""
    P, Q = _narrowed(p).to(torch.int32), _narrowed(q).to(torch.int32)
    return _narrowed(_coop_padd(f, P, Q)).to(torch.int32)


def _encoded_lanes(pts) -> torch.Tensor:
    """Host points -> (4, n, K) int32 canonical limbs, as DeviceTable's base."""
    enc = tc.edwards_engine().encode_points(pts)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(enc, (1, 2, 0))))


def _pair_add_operands(case: str, ed_table):
    """(consts, [(p, q), ...]) of one caller of pair_add ed25519."""
    consts, table, kp = ed_table
    eng = tc.edwards_engine()
    if case == "mesh_fold":  # reduce_points over partial sums: Horner outputs, then a padd output
        sums = kernels.window_sum_plain(consts, _basis(table, kp, 33), _digits(33, 24, seed=91))
        h = [kernels.horner_plain(consts, sums[..., 6 * i : 6 * i + 6], sums[..., 6 * i + 6 : 6 * i + 12])
             for i in (0, 2)]
        first = kernels.pair_add_plain(consts, h[0], h[1])
        return consts, [(h[0], h[1]), (first, sums[..., 18:24].contiguous())]
    if case == "p5":  # the probe's encoded points, at 64 lanes
        pc, p, q, _, _ = probes.add_inputs("cpu", lanes=64)
        return pc, [(p, q)]
    P, Q = _operands(table, kp, 8, seed=5)  # a doubling, the identity as q, as p
    Q[..., 3] = P[..., 3] = eng.identity(1, "cpu")[..., 0]  # and on both sides
    return consts, [(P, Q), (kernels.pair_add_plain(consts, P, Q), P)]


@pytest.mark.parametrize("case", ["mesh_fold", "p5", "edges"])
def test_narrowed_ed_pair_add_gives_pair_add_plain_limbs(ed_table, case):
    """The mesh fold's partial sums (Horner outputs and a padd output), P5's
    inputs, and a doubling and the identity on either side: every limb of
    the narrowed cooperative padd equals pair_add_plain's."""
    consts, pairs = _pair_add_operands(case, ed_table)
    f = FieldOps(tc.edwards_engine().n, consts)
    for p, q in pairs:
        assert torch.equal(_narrowed_pair_add(f, p, q), kernels.pair_add_plain(consts, p, q))


def test_narrowed_ed_pair_add_builds_the_range_table(range_table):
    """DeviceTable's build over four range basis points (B_blinding, G_0 ..
    G_2): 255 steps from the identity, each adding the encoded base point
    to the previous row, every row equal to the plain chain's limb for
    limb."""
    consts, _, _ = range_table
    f = FieldOps(tc.edwards_engine().n, consts)
    base = _encoded_lanes(bp_device._basis_points(64)[:4])
    acc = tc.edwards_engine().identity(4, "cpu")
    for _ in range(255):
        got = _narrowed_pair_add(f, acc, base)
        acc = kernels.pair_add_plain(consts, acc, base)
        assert torch.equal(got, acc)


# ---------------------------------------------------------------------------
# the narrowed chain (coop_chain_kernel<EdCoop>, probes.cu): P2
# ---------------------------------------------------------------------------


def test_narrowed_ed_chain_gives_padd_chain_plain_limbs():
    """P2's kernel over its probe's inputs at 8 lanes: p and q (encoded
    points, limbs in [0, 4096)) narrowed to int16 once, then R = 64
    cooperative padds in place, the accumulator as the kernel's shared
    memory holds it (int16) after every padd. Every padd output limb lies in
    [-1536, 5631] and the limbs equal padd_chain_plain's bit for bit."""
    consts, p, q, _, _ = probes.chain_inputs("cpu", lanes=8)
    assert 0 <= int(torch.minimum(p, q).min()) and int(torch.maximum(p, q).max()) < 4096
    f = FieldOps(tc.edwards_engine().n, consts)
    acc, add = _narrowed(p).to(torch.int32), _narrowed(q).to(torch.int32)
    for _ in range(probes.CHAIN_R):
        acc = _narrowed(_coop_padd(f, acc, add)).to(torch.int32)
        assert -1536 <= int(acc.min()) and int(acc.max()) <= 5631
    assert torch.equal(acc, kernels.padd_chain_plain(consts, p, q, probes.CHAIN_R))


# ---------------------------------------------------------------------------
# int32 headroom and the int16 interval at p = 2^255 - 19
# ---------------------------------------------------------------------------


def _padd_intervals(F: _IntervalField, two_d: _Iv, P, Q):
    """add-2008-hwcd-3 on intervals, operation for operation as
    EdwardsEngine.padd (and ed_padd_coop)."""
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    A = F.mul(F.sub(Y1, X1), F.sub(Y2, X2))
    B = F.mul(F.add(Y1, X1), F.add(Y2, X2))
    C = F.mul(F.mul(T1, T2), two_d)
    zz = F.mul(Z1, Z2)
    D = F.add(zz, zz)
    E, F_, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return [F.mul(E, F_), F.mul(G, H), F.mul(F_, G), F.mul(E, H)]


def _pdouble_intervals(F: _IntervalField, P):
    """dbl-2008-hwcd on intervals, as EdwardsEngine.pdouble (and
    ed_pdouble_coop)."""
    X, Y, Z, _ = P
    A, B, zz = F.mul(X, X), F.mul(Y, Y), F.mul(Z, Z)
    xy = F.add(X, Y)
    xy2 = F.mul(xy, xy)
    C, H, G = F.add(zz, zz), F.add(A, B), F.sub(A, B)
    E, F_ = F.sub(H, xy2), F.add(C, G)
    return [F.mul(E, F_), F.mul(G, H), F.mul(F_, G), F.mul(E, H)]


def test_edwards_int32_headroom():
    """From canonical limbs [0, 4095], padd's and pdouble's output limbs
    reach a fixed interval closed under both, inside int16 (the level store
    and the Horner chain's narrowing), and no intermediate of the int32
    schedule reaches 2^31: the numbers csrc/coop_sum.cuh states."""
    eng = tc.edwards_engine()
    F = _IntervalField(eng.ctx)
    row = eng.consts_np[F.n + 3].astype(np.int64)  # 2d
    two_d = _Iv(row, row)
    iv = _Iv(np.zeros(F.n, np.int64), np.full(F.n, _MASK, np.int64))
    for _ in range(10):
        outs = _padd_intervals(F, two_d, [iv] * 4, [iv] * 4) + _pdouble_intervals(F, [iv] * 4)
        lo = np.minimum(iv.lo, np.min([o.lo for o in outs], 0))
        hi = np.maximum(iv.hi, np.max([o.hi for o in outs], 0))
        if (lo == iv.lo).all() and (hi == iv.hi).all():
            break
        iv = _Iv(lo, hi)
    else:
        raise AssertionError("limb intervals did not close under padd and pdouble")
    assert (int(iv.lo.min()), int(iv.hi.max())) == (-1536, 5631)
    assert -(1 << 15) <= iv.lo.min() and iv.hi.max() < (1 << 15)
    assert F.peak < 2 ** 28.68


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 7, 8, 9, 160, 512, 1024, 1 << 18])
def test_ed_horner_geometry_fits_every_lane_count(B):
    """horner ed25519 at the range prover's lanes and pair_add ed25519 (the
    same geometry: one window) at the range table's K = 160 (20 one-warp
    blocks, one an SM) and P5's 2^18 lanes, and both at ragged counts."""
    blocks, warps, smem = kernels.coop_horner_geometry(CURVE, B, 1)
    assert warps == kernels.COOP_HORNER_WARPS
    lanes = warps * kernels.COOP_PADDS_PER_WARP[CURVE]
    assert lanes == 8
    assert (blocks - 1) * lanes < B <= blocks * lanes  # every lane has a group, no block is idle
    assert {160: 20, 1 << 18: 32768}.get(B, blocks) == blocks
    # per group: the accumulator and the window sum (p and q) as int16, 4 int32 rows of scratch
    assert smem == lanes * (2 * 192 + 384) == 6144


@pytest.mark.parametrize("lanes", [1, 127, 128, 512, 1024])
@pytest.mark.parametrize("K", [1, 2, 3, 20, 40, 95, 96, 160])
def test_ed_sum_geometry_fits_every_path_shape(K, lanes):
    """K1 at the range basis (160) and ragged K, tree_sum at the range
    basis's k_local at shard 2, 4 and 8 (96, 40, 20) and at ragged K and
    lane counts."""
    warps, smem = kernels.coop_sum_geometry(CURVE, K, lanes, H100_SMS)
    assert 1 <= warps <= kernels.COOP_MAX_WARPS
    store = (K + 1) // 2 * kernels.POINT_BYTES[CURVE]
    assert smem == store + warps * kernels.COOP_PADDS_PER_WARP[CURVE] * kernels.COOP_SCRATCH_BYTES[CURVE]
    assert smem <= kernels.SMEM_BLOCK_MAX
    assert warps <= max(1, -(-(K // 2) // kernels.COOP_PADDS_PER_WARP[CURVE]))
    # K1's rule: about ED_SUM_WARPS_PER_SM warps an SM over all lanes, at least one a lane
    assert warps == max(1, min(kernels.COOP_MAX_WARPS, -(-(K // 2) // kernels.COOP_PADDS_PER_WARP[CURVE]),
                               kernels.ED_SUM_WARPS_PER_SM * H100_SMS // lanes))
    if K == 160:  # the range basis: 1 warp a lane at T1||T2's and L||R's 1024 lanes, 2 at V, A, S's 512
        assert warps == {1: 10, 127: 8, 128: 8, 512: 2, 1024: 1}[lanes]
    if (K, lanes) == (96, 128):  # the mesh block: level 1's 48 padds in one pass, 128 blocks
        assert (warps, smem) == (6, 48 * 192 + 6 * 8 * 384)


@pytest.mark.parametrize("B", [1, 7, 8, 9, 512])
def test_ed_chain_geometry_fits_every_lane_count(B):
    """padd_chain (P2) runs pair_add ed25519's layout at CHAIN_WARPS warps
    a block: 32 lanes a block, so its probe's 512 lanes give 16 blocks, and
    ragged counts leave no lane without a group."""
    blocks, warps, smem = kernels.coop_horner_geometry(CURVE, B, 1, kernels.CHAIN_WARPS)
    assert warps == kernels.CHAIN_WARPS == 4
    lanes = warps * kernels.COOP_PADDS_PER_WARP[CURVE]
    assert (blocks - 1) * lanes < B <= blocks * lanes
    assert {512: 16}.get(B, blocks) == blocks
    # per group: the accumulator and q as int16 points, 4 int32 rows of scratch
    assert smem == lanes * (2 * kernels.POINT_BYTES[CURVE] + kernels.COOP_SCRATCH_BYTES[CURVE]) == 24576


def test_ed_geometry_raises_without_lanes_or_points():
    with pytest.raises(ValueError, match="at least one lane"):
        kernels.coop_horner_geometry(CURVE, 0, 1)
    with pytest.raises(ValueError, match="at least one point"):
        kernels.coop_sum_geometry(CURVE, 0, 1024, H100_SMS)
