"""The BN254 G2 window sums' and Horner chains' design (``csrc/coop_sum.cuh``,
``csrc/coop_horner.cuh``) on the CPU.

The CUDA kernels run only on the card; what they compute is held here at
small sizes against the plain versions:

* the cooperative padds' schedule (round 1, the Karatsuba rows, the rows
  rewritten in place, round 2, round 3, the output rows, with the kernel's
  row tables; six threads, or horner G2's 18) gives the limbs of the plain
  ``WeierstrassEngine.padd``;
* the halving tree with every level narrowed to int16, as the kernel's
  level store holds it, gives ``tree_sum_plain``'s limbs (and so the JAX
  ``_window_sum_call``'s, tests/test_torch_sharded_msm.py), on rows of a
  real multiples table;
* the Horner chain on that schedule (``coop_horner_kernel``: one window on
  the 18-thread padd for horner, four on the six-thread one for horner4),
  with its accumulator narrowed to int16 after every padd as the kernel's
  shared memory holds it, gives ``horner_plain``'s and ``horner4_plain``'s
  limbs (and so the JAX ``_horner_call``'s and ``_horner4_call``'s,
  tests/test_torch_sharded_msm.py and tests/test_torch_weierstrass.py);
* pair_add G2 (``coop_horner_kernel<G2Coop18, 1, 0>``): p and q narrowed to
  int16, then one padd on the 18-thread schedule, gives ``pair_add_plain``'s
  limbs (and so the JAX ``_pair_add_call``'s, tests/test_torch_weierstrass.py)
  on the table build's operands and the mesh fold's Horner outputs;
* the wrappers' launch geometry fits a block's shared memory at every shape
  the paths use, and a shape that cannot fit raises.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.ops import curve as tc
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops.limbfold import FieldOps
from libzkp_tpu_torch.ops.weierstrass import get_engine

CURVE = "bn254_g2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def g2_base():
    """6 random G2 points, encoded: (6, 6, n) int32 limbs."""
    g = bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y))
    rng = random.Random(5)
    return get_engine(CURVE).encode_points([bn.g2_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(6)])


@pytest.fixture(scope="module")
def g2_table(g2_base):
    """Consts and the (Kp * 256, 6, n) int16 multiples table of the 6
    points (Kp = 8), built by the plain table-add chain."""
    table = tc.DeviceTable(g2_base, device="cpu", curve=CURVE)
    return torch.from_numpy(get_engine(CURVE).consts_np), table.table, table.Kp


def _gathered(table, kp: int, K: int, lanes: int, seed: int) -> torch.Tensor:
    """(lanes, K, 6, n) int16 rows of the table at random digits, basis
    point k % kp for position k, as the mesh's gather lays them out."""
    digits = np.random.default_rng(seed).integers(0, 256, (lanes, K))
    rows = (np.arange(K) % kp) * 256 + digits
    return table[torch.from_numpy(rows)]


# ---------------------------------------------------------------------------
# the cooperative padds' schedule (csrc/coop_sum.cuh g2_padd_coop and
# g2_padd_coop18)
# ---------------------------------------------------------------------------


def _coop_padd(f: FieldOps, P: torch.Tensor, Q: torch.Tensor, group: int = 6) -> torch.Tensor:
    """g2_padd_coop (``group`` 6) or g2_padd_coop18 (18) row by row, with
    each one's thread-to-row maps in rounds 1 and 3 and the Karatsuba rows:
    P, Q (6, n, L) int32 -> P + Q (6, n, L)."""

    def r1_row(pt, j, k):
        r = pt[2 * (j if j < 3 else (1 if j == 4 else 0)) + k]
        if j >= 3:
            r = f.carry(r + pt[2 * (1 if j == 3 else 2) + k])
        return r

    def r1_operand(pt, j, s):
        return r1_row(pt, j, s) if s < 2 else f.carry(r1_row(pt, j, 0) + r1_row(pt, j, 1))

    def operand(rows, at, s):
        return rows[at + s] if s < 2 else f.carry(rows[at] + rows[at + 1])

    def kara(M, j, k):
        r = f.carry(M[3 * j + (2 if k else 0)] - M[3 * j + (0 if k else 1)])
        return f.carry(r - M[3 * j + 1]) if k else r

    per, rows_per = 18 // group, 2 if group == 6 else 1

    def products(A, B):
        """M's 18 rows as the group's threads compute them: thread g takes
        products p = per * g .. per * (g + 1) - 1 (six threads: pair g's
        three; 18: one), product p % 3 of pair p // 3 at row p."""
        M = [None] * 18
        for g in range(group):
            for p in range(per * g, per * (g + 1)):
                M[p] = f.mul(A(p // 3, p % 3), B(p // 3, p % 3))
        return M

    M = products(lambda j, s: r1_operand(P, j, s), lambda j, s: r1_operand(Q, j, s))
    T = [None] * 12  # t0, t1, t2, t3, t4, X3, component r & 1 of pair r >> 1 at row r
    for g in range(group):
        for r in range(rows_per * g, min(rows_per * (g + 1), 12)):
            T[r] = kara(M, r >> 1, r & 1)
    X = []
    for g in range(6):  # in place: t3 -= t0 + t1, t4 -= t1 + t2, Y3 = X3 - (t0 + t2)
        v, k = 3 + (g >> 1), g & 1
        u = f.carry(T[2 * (1 if v == 4 else 0) + k] + T[2 * (1 if v == 3 else 2) + k])
        T[2 * v + k] = f.carry(T[2 * v + k] - u)
        if g < 2:
            X.append(f.carry(T[g] + T[g] + T[g]))
    b3 = [f.extra_const(0), f.extra_const(1)]
    M = [f.mul(operand(T, 4 if g < 3 else 10, g % 3), operand(b3, 0, g % 3)) for g in range(6)]
    for g in range(6):  # t1 - b3 t2 -> t0's rows, b3 Y3 -> Y3's, t1 + b3 t2 -> t2's
        k, kind = g & 1, g >> 1
        r = kara(M, 1 if kind == 1 else 0, k)
        if kind != 1:
            r = f.carry(T[2 + k] - r if kind == 0 else T[2 + k] + r)
        T[2 * (0 if kind == 0 else (5 if kind == 1 else 2)) + k] = r
    rows = T + X
    M = products(lambda j, s: operand(rows, 2 * ((0x625043 >> (4 * j)) & 15), s),
                 lambda j, s: operand(rows, 2 * ((0x346250 >> (4 * j)) & 15), s))
    out = []
    for g in range(6):
        c, k = g >> 1, g & 1
        a, b = kara(M, 2 * c, k), kara(M, 2 * c + 1, k)
        out.append(f.carry(a - b if c == 0 else a + b))
    return torch.stack(out)


def _check_padd_schedule(g2_table, group: int) -> None:
    consts, table, _ = g2_table
    eng = get_engine(CURVE)
    f = FieldOps(eng.n, consts)
    pts = _gathered(table, 8, 2, 16, seed=1).to(torch.int32)  # (16, 2, 6, n)
    P = pts[:, 0].permute(1, 2, 0).contiguous()
    Q = pts[:, 1].permute(1, 2, 0).contiguous()
    Q[..., 0] = P[..., 0]
    Q[..., 1] = eng.identity(1, "cpu")[..., 0]
    P[..., 2] = eng.identity(1, "cpu")[..., 0]
    for _ in range(2):
        want = eng.padd(consts, P, Q)
        assert torch.equal(_coop_padd(f, P, Q, group), want)
        P, Q = want, P


def test_cooperative_padd_schedule_gives_padd_limbs(g2_table):
    """Distinct points, a doubling, the identity on either side, and padd
    outputs as inputs: every limb equals the plain padd's."""
    _check_padd_schedule(g2_table, 6)


def test_cooperative_padd18_schedule_gives_padd_limbs(g2_table):
    """The same for g2_padd_coop18 (horner G2), one product a thread."""
    _check_padd_schedule(g2_table, 18)


# ---------------------------------------------------------------------------
# the narrowed halving tree (coop_tree_sum's level store)
# ---------------------------------------------------------------------------


def _narrowed_tree_sum(consts: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """coop_tree_sum's order and storage: level 1 from the int16 rows, every
    level's outputs (and the carried odd point) narrowed to int16 in the
    level store, the last one widened. (B, K, 6, n) int16 -> (6, n, B)."""
    eng = get_engine(CURVE)
    v = pts.permute(1, 2, 3, 0)  # (K, 6, n, B) int16
    while v.shape[0] > 1:
        K, half = v.shape[0], v.shape[0] // 2
        s = eng.padd(consts, v[:half].to(torch.int32), v[half : 2 * half].to(torch.int32))
        narrowed = s.to(torch.int16)
        assert torch.equal(narrowed.to(torch.int32), s), "a level's limbs left int16"
        v = torch.cat([narrowed, v[-1:]]) if K % 2 else narrowed
    return v[0].to(torch.int32)


@pytest.mark.parametrize("K", [1, 2, 3, 33, 192, 352])
def test_narrowed_tree_gives_tree_sum_plain_limbs(g2_table, K):
    consts, table, kp = g2_table
    pts = _gathered(table, kp, K, 3, seed=K)
    got = _narrowed_tree_sum(consts, pts)
    assert got.shape == (6, get_engine(CURVE).n, 3)
    assert torch.equal(got, kernels.tree_sum_plain(consts, pts, curve=CURVE))


# ---------------------------------------------------------------------------
# the narrowed Horner chain (coop_horner_kernel<G2Coop, WG>)
# ---------------------------------------------------------------------------


# WG = 4 (horner4) keeps its earlier ids; WG = 1 is horner
@pytest.mark.parametrize("WG, B", [(4, 1), (4, 5), (4, 6), (1, 1), (1, 5), (1, 6)],
                         ids=["1", "5", "6", "wg1-1", "wg1-5", "wg1-6"])
def test_narrowed_horner_chain_gives_horner4_plain_limbs(g2_table, WG, B):
    """coop_horner_kernel's chain: the accumulator and the WG window sums
    narrowed to int16 once, then WG x (8 doublings + 1 addition) on the
    cooperative schedule (horner: g2_padd_coop18's, horner4:
    g2_padd_coop's), the accumulator narrowed after every padd. Lane 0
    starts from the identity (the MSM's first window), the others from window
    sums; every intermediate fits int16 and the limbs equal horner_plain's
    (WG = 1) or horner4_plain's (WG = 4)."""
    consts, table, kp = g2_table
    eng = get_engine(CURVE)
    f = FieldOps(eng.n, consts)
    sums = kernels.tree_sum_plain(consts, _gathered(table, kp, 3, (1 + WG) * B, seed=40 + B), curve=CURVE)
    acc0 = sums[..., :B].clone()
    acc0[..., 0] = eng.identity(1, "cpu")[..., 0]
    wsums = sums[..., B:].contiguous()

    def narrowed(x):
        n16 = x.to(torch.int16)
        assert torch.equal(n16.to(torch.int32), x), "a limb left int16"
        return n16.to(torch.int32)

    acc = narrowed(acc0)
    for w in range(WG):
        win = narrowed(wsums[..., w * B : (w + 1) * B])
        for r in range(9):
            acc = narrowed(_coop_padd(f, acc, acc if r < 8 else win, 18 if WG == 1 else 6))
    plain = kernels.horner_plain if WG == 1 else kernels.horner4_plain
    assert torch.equal(acc, plain(consts, acc0, wsums, curve=CURVE))


# ---------------------------------------------------------------------------
# the narrowed pair_add (coop_horner_kernel<G2Coop18, 1, 0>)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 5, 6, 128, 352])
def test_narrowed_pair_add_gives_pair_add_plain_limbs(g2_base, g2_table, K):
    """pair_add G2: p and q narrowed to int16, then one padd on the
    18-thread schedule. Lanes as the paths give them: a table build step,
    row d of basis point k plus its encoded base (lane 0: the identity plus
    the base; lane 1: row 1 plus the base, the build's doubling at step 2;
    the basis's padded points: the identity twice), and, in every third
    lane from lane 2, two Horner outputs as the mesh fold adds them; the
    limbs, and the output's narrowing, equal pair_add_plain's."""
    consts, table, kp = g2_table
    eng = get_engine(CURVE)
    f = FieldOps(eng.n, consts)
    k = np.arange(K) % kp
    d = np.random.default_rng(60 + K).integers(0, 255, K)
    d[:2] = [0, 1][:K]
    p = table[torch.from_numpy(k * 256 + d)].permute(1, 2, 0).to(torch.int32)
    pad = np.broadcast_to(eng.identity_np()[None], (kp - len(g2_base),) + g2_base.shape[1:])
    base = np.concatenate([g2_base, pad])  # DeviceTable's padded basis
    q = torch.from_numpy(np.ascontiguousarray(np.transpose(base[k], (1, 2, 0))))
    sums = kernels.tree_sum_plain(consts, _gathered(table, kp, 3, 8, seed=70), curve=CURVE)
    horners = kernels.horner_plain(consts, sums[..., :4], sums[..., 4:], curve=CURVE)
    fold = torch.arange(K)[2::3]
    p[..., fold] = horners[..., fold % 4]
    q[..., fold] = horners[..., (fold + 1) % 4]

    def narrowed(x):
        n16 = x.to(torch.int16)
        assert torch.equal(n16.to(torch.int32), x), "a limb left int16"
        return n16.to(torch.int32)

    got = narrowed(_coop_padd(f, narrowed(p), narrowed(q), 18))
    assert torch.equal(got, kernels.pair_add_plain(consts, p, q, curve=CURVE))


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

H100_SMS = 132
G2_KP = 352  # the b_g2 query's padded basis
# k_local of the b_g2 query on a mesh of shard 1, 2, 4, 8 (curve.ShardedTable)
G2_K_LOCAL = {s: ((G2_KP + s - 1) // s + 31) // 32 * 32 for s in (1, 2, 4, 8)}


@pytest.mark.parametrize("kernel", ["window_sum4", "tree_sum"])
@pytest.mark.parametrize("B", [1, 128, 256])
def test_g2_geometry_fits_every_path_shape(kernel, B):
    assert G2_K_LOCAL == {1: 352, 2: 192, 4: 96, 8: 64}
    shapes = ([(G2_KP, kernels.WIN_GROUP * B)] if kernel == "window_sum4"
              else [(k, B) for k in G2_K_LOCAL.values()])
    for K, lanes in shapes:
        warps, smem = kernels.coop_sum_geometry(CURVE, K, lanes, H100_SMS)
        assert 1 <= warps <= kernels.COOP_MAX_WARPS
        store = (K + 1) // 2 * kernels.POINT_BYTES[CURVE]
        assert smem == store + warps * kernels.COOP_PADDS_PER_WARP[CURVE] * kernels.COOP_SCRATCH_BYTES[CURVE]
        assert smem <= kernels.SMEM_BLOCK_MAX
        # no more warps than level 1 has padds for
        assert warps <= max(1, -(-(K // 2) // kernels.COOP_PADDS_PER_WARP[CURVE]))
        if lanes >= 2 * H100_SMS:  # two blocks share an SM
            assert 2 * (smem + 1024) <= kernels.SMEM_SM


@pytest.mark.parametrize("B", [1, 128, 256])
def test_window_sum4_g2_geometry_fits_the_membership_query(B):
    """The membership key's b_g2 query, 589 points padded to Kp 608: one
    block a lane within a block's shared memory, two blocks an SM from 256
    statements."""
    K, lanes = 608, kernels.WIN_GROUP * B
    warps, smem = kernels.coop_sum_geometry(CURVE, K, lanes, H100_SMS)
    assert 1 <= warps <= max(1, -(-(K // 2) // kernels.COOP_PADDS_PER_WARP[CURVE]))
    per_warp = kernels.COOP_PADDS_PER_WARP[CURVE] * kernels.COOP_SCRATCH_BYTES[CURVE]
    assert smem == (K + 1) // 2 * kernels.POINT_BYTES[CURVE] + warps * per_warp <= kernels.SMEM_BLOCK_MAX
    if lanes >= 2 * H100_SMS:
        assert 2 * (smem + 1024) <= kernels.SMEM_SM


def test_g2_geometry_raises_above_a_blocks_shared_memory():
    per_warp = kernels.COOP_PADDS_PER_WARP[CURVE] * kernels.COOP_SCRATCH_BYTES[CURVE]
    k_max = (kernels.SMEM_BLOCK_MAX - per_warp) // kernels.POINT_BYTES[CURVE] * 2
    assert kernels.coop_sum_geometry(CURVE, k_max, 1, H100_SMS)[1] <= kernels.SMEM_BLOCK_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kernels.coop_sum_geometry(CURVE, k_max + 1, 1, H100_SMS)
    with pytest.raises(ValueError, match="at least one point"):
        kernels.coop_sum_geometry(CURVE, 0, 1, H100_SMS)


def _check_horner_geometry(B: int, WG: int) -> None:
    blocks, warps, smem = kernels.coop_horner_geometry(CURVE, B, WG)
    assert warps == kernels.COOP_HORNER_WARPS
    # horner G2: one 18-thread group a warp; horner4 G2: five six-thread groups
    lanes = warps * (kernels.G2_HORNER_PER_WARP if WG == 1 else kernels.COOP_PADDS_PER_WARP[CURVE])
    assert (blocks - 1) * lanes < B <= blocks * lanes  # every lane has a group, no block is idle
    assert smem == lanes * ((1 + WG) * kernels.POINT_BYTES[CURVE] + kernels.COOP_SCRATCH_BYTES[CURVE])
    assert smem <= kernels.SMEM_BLOCK_MAX


@pytest.mark.parametrize("B", [1, 5, 6, 128, 256, 1024])
def test_horner4_g2_geometry_fits_every_lane_count(B):
    _check_horner_geometry(B, kernels.WIN_GROUP)
    assert kernels.coop_horner_geometry(CURVE, B, kernels.WIN_GROUP)[2] == 4512 * 5


@pytest.mark.parametrize("B", [1, 5, 6, 128, 256, 1024])
def test_horner_g2_geometry_fits_every_lane_count(B):
    _check_horner_geometry(B, 1)
    assert kernels.coop_horner_geometry(CURVE, B, 1) == (B, 1, 3648)  # one lane a block


@pytest.mark.parametrize("K", [1, 5, 6, 128, 352, 1024])
def test_pair_add_g2_geometry_fits_every_lane_count(K):
    """pair_add G2 launches on horner G2's geometry: one 18-thread group a
    lane, one lane a one-warp block, p, q and a padd's scratch in shared
    memory."""
    _check_horner_geometry(K, 1)
    assert kernels.coop_horner_geometry(CURVE, K, 1) == (K, 1, 2 * kernels.POINT_BYTES[CURVE] + 3072)


def test_pair_add_g2_geometry_raises_without_lanes():
    with pytest.raises(ValueError, match="at least one lane"):
        kernels.coop_horner_geometry(CURVE, 0, 1)


def test_horner4_g2_geometry_raises_without_lanes():
    with pytest.raises(ValueError, match="at least one lane"):
        kernels.coop_horner_geometry(CURVE, 0, kernels.WIN_GROUP)


def test_horner_g2_geometry_raises_without_lanes():
    with pytest.raises(ValueError, match="at least one lane"):
        kernels.coop_horner_geometry(CURVE, 0, 1)
