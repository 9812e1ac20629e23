"""The BN254 G1 tree sum's and Horner step's design (``csrc/coop_sum.cuh``,
``csrc/coop_horner.cuh``) on the CPU.

The CUDA kernel runs only on the card; what it computes is held here at
small sizes against the plain versions:

* the cooperative G1 padd's schedule (round 1, the one stage of rows, round
  3, the output rows, with the kernel's row tables) gives the limbs of the
  plain ``WeierstrassEngine.padd``;
* the halving tree on that schedule, with every level narrowed to int16 as
  the kernel's level store holds it, gives ``tree_sum_plain``'s limbs (and
  so the JAX ``_window_sum_call``'s, tests/test_torch_sharded_msm.py), on
  rows of a real multiples table;
* the Horner chain on that schedule (``coop_horner_kernel<G1Coop, WG, 8>``:
  one window for horner G1, four for horner4 G1), with the accumulator and
  the window sums narrowed to int16 and every padd output narrowed as the
  kernel's shared memory holds it, gives ``horner_plain``'s and
  ``horner4_plain``'s limbs (and so the JAX ``_horner_call``'s and
  ``_horner4_call``'s, tests/test_torch_sharded_msm.py and
  tests/test_torch_weierstrass.py);
* window_sum4 G1's order (``csrc/window_sum4.cu``: each lane's G nodes of
  the plain tree summed one padd at a time by one group each, the leaf pairs
  in bit-reversed order, then the tree over the nodes), on that schedule
  with every padd output narrowed to int16, gives the JAX
  ``_window_fused4_call``'s limbs at every G;
* pair_add G1 (``coop_horner_kernel<G1Coop, 1, 0>``): p and q narrowed to
  int16, then one padd on the schedule, gives ``pair_add_plain``'s limbs;
* the wrappers' launch geometry fits a block's shared memory at every shape
  the mesh gives ``tree_sum`` G1, at every lane count of a Horner step and
  at every window_sum4 G1 shape of the Groth16 paths (and the SM's
  registers, as the kernels' launch bounds give them), and a shape that
  cannot fit raises.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import curve_jax as cj
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.ops import curve as tc
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops.limbfold import FieldOps
from libzkp_tpu_torch.ops.weierstrass import get_engine

CURVE = "bn254_g1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def g1_base():
    """6 random G1 points, encoded: (6, 3, n) int32 limbs."""
    rng = random.Random(6)
    g = bn.g1_from_affine(bn.G1_GEN)
    return get_engine(CURVE).encode_points([bn.g1_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(6)])


@pytest.fixture(scope="module")
def g1_table(g1_base):
    """Consts and the (Kp * 256, 3, n) int16 multiples table of the 6
    points (Kp = 8), built by the plain table-add chain."""
    table = tc.DeviceTable(g1_base, device="cpu", curve=CURVE)
    return torch.from_numpy(get_engine(CURVE).consts_np), table.table, table.Kp


def _gathered(table, kp: int, K: int, lanes: int, seed: int) -> torch.Tensor:
    """(lanes, K, 3, n) int16 rows of the table at random digits, basis
    point k % kp for position k, as the mesh's gather lays them out."""
    digits = np.random.default_rng(seed).integers(0, 256, (lanes, K))
    rows = (np.arange(K) % kp) * 256 + digits
    return table[torch.from_numpy(rows)]


# ---------------------------------------------------------------------------
# the cooperative padd's schedule (csrc/coop_sum.cuh g1_padd_coop)
# ---------------------------------------------------------------------------


def _coop_padd(f: FieldOps, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """g1_padd_coop row by row: P, Q (3, n, L) int32 -> P + Q (3, n, L)."""

    def r1_operand(pt, j):
        r = pt[j if j < 3 else (1 if j == 4 else 0)]
        return f.carry(r + pt[1 if j == 3 else 2]) if j >= 3 else r

    T = [f.mul(r1_operand(P, g), r1_operand(Q, g)) for g in range(6)]  # t0, t1, t2, t3, t4, X3
    rows = list(T) + [None] * 3
    for g in range(6):  # one value a thread, from round 1's rows only
        if g == 0:
            rows[6] = f.carry(T[0] + T[0] + T[0])
        elif g < 3:
            b3t2 = f.smul(T[2], 9)
            rows[6 + g] = f.carry(T[1] - b3t2 if g == 1 else T[1] + b3t2)
        else:
            u = f.carry(T[1 if g == 4 else 0] + T[1 if g == 3 else 2])
            r = f.carry(T[g] - u)
            rows[g] = f.smul(r, 9) if g == 5 else r
    M = [f.mul(rows[(0x685743 >> (4 * g)) & 15], rows[(0x346857 >> (4 * g)) & 15]) for g in range(6)]
    return torch.stack([f.carry(M[0] - M[1]), f.carry(M[2] + M[3]), f.carry(M[4] + M[5])])


def test_cooperative_g1_padd_schedule_gives_padd_limbs(g1_table):
    """Distinct points, a doubling, the identity on either side, and padd
    outputs as inputs: every limb equals the plain padd's."""
    consts, table, _ = g1_table
    eng = get_engine(CURVE)
    f = FieldOps(eng.n, consts)
    pts = _gathered(table, 8, 2, 16, seed=1).to(torch.int32)  # (16, 2, 3, n)
    P = pts[:, 0].permute(1, 2, 0).contiguous()
    Q = pts[:, 1].permute(1, 2, 0).contiguous()
    Q[..., 0] = P[..., 0]
    Q[..., 1] = eng.identity(1, "cpu")[..., 0]
    P[..., 2] = eng.identity(1, "cpu")[..., 0]
    for _ in range(3):
        want = eng.padd(consts, P, Q)
        assert torch.equal(_coop_padd(f, P, Q), want)
        P, Q = want, P


# ---------------------------------------------------------------------------
# the narrowed halving tree (coop_tree_sum's level store) on the schedule
# ---------------------------------------------------------------------------


def _narrowed_tree_sum(f: FieldOps, pts: torch.Tensor) -> torch.Tensor:
    """coop_tree_sum's order and storage with g1_padd_coop's schedule: level
    1 from the int16 rows, every level's outputs (and the carried odd point)
    narrowed to int16 in the level store, the last one widened.
    (B, K, 3, n) int16 -> (3, n, B)."""
    B, n = pts.shape[0], pts.shape[-1]
    v = pts.permute(1, 2, 3, 0)  # (K, 3, n, B) int16
    while v.shape[0] > 1:
        K, half = v.shape[0], v.shape[0] // 2

        def lanes(x):  # (half, 3, n, B) -> (3, n, half * B)
            return x.to(torch.int32).permute(1, 2, 0, 3).reshape(3, n, half * B)

        s = _coop_padd(f, lanes(v[:half]), lanes(v[half : 2 * half]))
        s = s.reshape(3, n, half, B).permute(2, 0, 1, 3)
        narrowed = s.to(torch.int16)
        assert torch.equal(narrowed.to(torch.int32), s), "a level's limbs left int16"
        v = torch.cat([narrowed, v[-1:]]) if K % 2 else narrowed
    return v[0].to(torch.int32)


@pytest.mark.parametrize("K", [1, 2, 3, 33, 192, 256])
def test_narrowed_g1_tree_gives_tree_sum_plain_limbs(g1_table, K):
    consts, table, kp = g1_table
    pts = _gathered(table, kp, K, 3, seed=K)
    got = _narrowed_tree_sum(FieldOps(get_engine(CURVE).n, consts), pts)
    assert got.shape == (3, get_engine(CURVE).n, 3)
    assert torch.equal(got, kernels.tree_sum_plain(consts, pts, curve=CURVE))


# ---------------------------------------------------------------------------
# the narrowed Horner chain (coop_horner_kernel<G1Coop, WG, 8>)
# ---------------------------------------------------------------------------


# WG = 1 (horner) keeps its earlier ids; WG = 4 is horner4
@pytest.mark.parametrize("WG, B", [(1, 1), (1, 5), (1, 6), (4, 1), (4, 5), (4, 6)],
                         ids=["1", "5", "6", "wg4-1", "wg4-5", "wg4-6"])
def test_narrowed_g1_horner_chain_gives_horner_plain_limbs(g1_table, WG, B):
    """coop_horner_kernel's G1 chain: the accumulator and the WG window
    sums narrowed to int16 once, then WG x (8 doublings + 1 addition) on the
    cooperative schedule, the accumulator narrowed after every padd. Lane 0
    starts from the identity (the MSM's first window), the others from
    window sums (tree sums of table rows); every intermediate fits int16 and
    the limbs equal horner_plain's (WG = 1) or horner4_plain's (WG = 4)."""
    consts, table, kp = g1_table
    eng = get_engine(CURVE)
    f = FieldOps(eng.n, consts)
    sums = kernels.tree_sum_plain(consts, _gathered(table, kp, 3, (1 + WG) * B, seed=50 + B), curve=CURVE)
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
            acc = narrowed(_coop_padd(f, acc, acc if r < 8 else win))
    plain = kernels.horner_plain if WG == 1 else kernels.horner4_plain
    assert torch.equal(acc, plain(consts, acc0, wsums, curve=CURVE))


# ---------------------------------------------------------------------------
# window_sum4 G1's order (csrc/window_sum4.cu kernels 1 and 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def g1_jax_table():
    """The JAX package's host-built table of 64 random G1 points (Kp = 64)
    and the JAX consts."""
    rng = random.Random(64)
    g = bn.g1_from_affine(bn.G1_GEN)
    jt = cj.build_table_bn254_g1([bn.g1_scalar_mul(rng.randrange(1, bn.R), g) for _ in range(64)])
    assert jt.Kp == 64
    return jt, jnp.asarray(cj.bn254_g1_engine().consts_np)


def _jax_window_sum4(jt, jc, Kp: int, dig: np.ndarray) -> np.ndarray:
    """The JAX window sum of the first Kp basis points, as the JAX tests run
    it on the CPU: the ``_window_fused4_call`` branch where its K chunk
    divides Kp, else its plain reference, ``_tree_reduce`` over the
    engine's padd on the gathered rows (Kp = 33)."""
    B = dig.shape[-1]
    if Kp % min(cj.K_CHUNK, Kp) == 0:
        return np.asarray(cj._window_fused4_call(CURVE, Kp, B)(jc, jt.table_int8_packed[:Kp], jnp.asarray(dig)))
    ej = cj.bn254_g1_engine()
    d = np.transpose(dig, (1, 0, 2)).reshape(Kp, -1)
    rows = jt.table[jnp.asarray(d + 256 * np.arange(Kp)[:, None])].astype(jnp.int32)  # (Kp, 4B, 3, n)
    return np.asarray(cj._tree_reduce(lambda a, b: ej.padd(jc, a, b), jnp.transpose(rows, (0, 2, 3, 1))))


@pytest.mark.parametrize("Kp", [1, 2, 8, 33, 64])
@pytest.mark.parametrize("B", [1, 3])
def test_window_sum4_g1_order_gives_jax_limbs(g1_jax_table, Kp, B):
    """window_sum4_order on the cooperative schedule, every padd output
    narrowed to int16 (it raises where a limb leaves int16), at every G the
    geometry may choose (Kp, Kp / 2, ... down to Kp's odd part: kernel 1's
    chains of 2^l points and kernel 2's tree), gives the JAX
    _window_fused4_call's limbs on the same table and seeded digits."""
    jt, jc = g1_jax_table
    dig = np.random.default_rng(100 * Kp + B).integers(0, 256, (kernels.WIN_GROUP, Kp, B)).astype(np.int32)
    want = _jax_window_sum4(jt, jc, Kp, dig)
    assert want.shape == (3, get_engine(CURVE).n, kernels.WIN_GROUP * B)
    consts = torch.from_numpy(get_engine(CURVE).consts_np)
    table = convert.multiples_table(np.asarray(jt.table)[:Kp * 256], Kp, device="cpu", curve=CURVE).table
    f = FieldOps(get_engine(CURVE).n, consts)
    G = Kp
    while True:
        got = kernels.window_sum4_order(consts, table, torch.from_numpy(dig), groups=G,
                                        padd=lambda p, q: _coop_padd(f, p, q))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"G = {G}")
        if G % 2:
            break
        G //= 2


# ---------------------------------------------------------------------------
# the narrowed pair_add (coop_horner_kernel<G1Coop, 1, 0>)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 5, 6, 8, 352])
def test_narrowed_g1_pair_add_gives_pair_add_plain_limbs(g1_base, g1_table, K):
    """pair_add G1: p and q narrowed to int16, then one padd on the
    six-thread schedule. Lanes as the paths give them: a table build step,
    row d of basis point k plus its encoded base (lane 0: the identity plus
    the base; lane 1: row 1 plus the base, the build's doubling at step 2;
    the basis's padded points: the identity twice), and, in every third
    lane from lane 2, two Horner outputs as the mesh fold adds them; the
    limbs, and the output's narrowing, equal pair_add_plain's."""
    consts, table, kp = g1_table
    eng = get_engine(CURVE)
    f = FieldOps(eng.n, consts)
    k = np.arange(K) % kp
    d = np.random.default_rng(80 + K).integers(0, 255, K)
    d[:2] = [0, 1][:K]
    p = table[torch.from_numpy(k * 256 + d)].permute(1, 2, 0).to(torch.int32)
    pad = np.broadcast_to(eng.identity_np()[None], (kp - len(g1_base),) + g1_base.shape[1:])
    base = np.concatenate([g1_base, pad])  # DeviceTable's padded basis
    q = torch.from_numpy(np.ascontiguousarray(np.transpose(base[k], (1, 2, 0))))
    sums = kernels.tree_sum_plain(consts, _gathered(table, kp, 3, 8, seed=90), curve=CURVE)
    horners = kernels.horner_plain(consts, sums[..., :4], sums[..., 4:], curve=CURVE)
    fold = torch.arange(K)[2::3]
    p[..., fold] = horners[..., fold % 4]
    q[..., fold] = horners[..., (fold + 1) % 4]

    def narrowed(x):
        n16 = x.to(torch.int16)
        assert torch.equal(n16.to(torch.int32), x), "a limb left int16"
        return n16.to(torch.int32)

    got = narrowed(_coop_padd(f, narrowed(p), narrowed(q)))
    assert torch.equal(got, kernels.pair_add_plain(consts, p, q, curve=CURVE))


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

H100_SMS = 132
# k_local of the G1 queries on a mesh of shard 1, 2, 4, 8 (curve.ShardedTable):
# the h query (Kp 512) and the a, b_g1 and l queries (Kp 352)
G1_K_LOCAL = {kp: {s: ((kp + s - 1) // s + 31) // 32 * 32 for s in (1, 2, 4, 8)} for kp in (512, 352)}


@pytest.mark.parametrize("B", [1, 128, 256])
def test_g1_geometry_fits_every_path_shape(B):
    assert G1_K_LOCAL == {512: {1: 512, 2: 256, 4: 128, 8: 64}, 352: {1: 352, 2: 192, 4: 96, 8: 64}}
    for K in sorted({k for ks in G1_K_LOCAL.values() for k in ks.values()}):
        warps, smem = kernels.coop_sum_geometry(CURVE, K, B, H100_SMS)
        assert 1 <= warps <= kernels.COOP_MAX_WARPS
        store = (K + 1) // 2 * kernels.POINT_BYTES[CURVE]
        assert smem == store + warps * kernels.COOP_PADDS_PER_WARP[CURVE] * kernels.COOP_SCRATCH_BYTES[CURVE]
        assert smem <= kernels.SMEM_BLOCK_MAX
        # no more warps than level 1 has padds for, and every warp it can use
        assert warps == min(kernels.COOP_MAX_WARPS, -(-(K // 2) // kernels.COOP_PADDS_PER_WARP[CURVE]))


def test_g1_geometry_raises_above_a_blocks_shared_memory():
    per_warp = kernels.COOP_PADDS_PER_WARP[CURVE] * kernels.COOP_SCRATCH_BYTES[CURVE]
    k_max = (kernels.SMEM_BLOCK_MAX - per_warp) // kernels.POINT_BYTES[CURVE] * 2
    assert kernels.coop_sum_geometry(CURVE, k_max, 1, H100_SMS)[1] <= kernels.SMEM_BLOCK_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kernels.coop_sum_geometry(CURVE, k_max + 1, 1, H100_SMS)
    with pytest.raises(ValueError, match="at least one point"):
        kernels.coop_sum_geometry(CURVE, 0, 1, H100_SMS)


@pytest.mark.parametrize("WG", [1, 4])
@pytest.mark.parametrize("B", [1, 5, 6, 128, 256, 1024])
def test_horner_g1_geometry_fits_every_lane_count(B, WG):
    blocks, warps, smem = kernels.coop_horner_geometry(CURVE, B, WG)
    assert warps == kernels.COOP_HORNER_WARPS
    lanes = warps * kernels.COOP_PADDS_PER_WARP[CURVE]
    assert (blocks - 1) * lanes < B <= blocks * lanes  # every lane has a group, no block is idle
    assert smem == lanes * ((1 + WG) * kernels.POINT_BYTES[CURVE] + kernels.COOP_SCRATCH_BYTES[CURVE])
    assert smem <= kernels.SMEM_BLOCK_MAX
    if WG == 1:  # horner G1: 1,728 bytes a group
        assert smem == 1728 * lanes


def test_horner_g1_geometry_raises_without_lanes():
    with pytest.raises(ValueError, match="at least one lane"):
        kernels.coop_horner_geometry(CURVE, 0, 1)


# (Kp, lanes) -> G the rule gives on an H100: the h query and the a, b_g1, l
# queries at 256 statements (two waves of kernel 1 blocks), a statement's
# table on the grouped route and the h query at its 8 statements (the
# fewest dependent padd steps); the membership key's a and b_g1 (Kp 608 =
# 19 * 32), h (1024) and l (480 = 15 * 32) queries at 256 statements
WS4_G1_PATH_G = {(512, 1024): 32, (352, 1024): 44, (8, 128): 8, (512, 32): 128,
                 (608, 1024): 38, (1024, 1024): 32, (480, 1024): 30}


@pytest.mark.parametrize("Kp", [8, 352, 512, 480, 608, 1024])
@pytest.mark.parametrize("B", [1, 8, 32, 256])
def test_window_sum4_g1_geometry_fits_every_path_shape(Kp, B):
    """Kernel 1's blocks fit WS4_G1_NODE_BLOCKS to an SM (their launch
    bounds give each at most 112 registers: 18 one-warp blocks take 64,512
    of the SM's 65,536) and kernel 2's two to an SM (at most 8 warps of 128
    registers), both within a block's shared memory; G splits Kp into
    powers of two."""
    lanes = kernels.WIN_GROUP * B
    G, nodes_smem, warps, smem = kernels.window_sum4_g1_geometry(Kp, lanes, H100_SMS)
    assert Kp % G == 0 and (Kp // G) & (Kp // G - 1) == 0
    ell = (Kp // G).bit_length() - 1
    padds, point = kernels.COOP_PADDS_PER_WARP[CURVE], kernels.POINT_BYTES[CURVE]
    scratch = kernels.COOP_SCRATCH_BYTES[CURVE]
    if ell:
        assert nodes_smem == padds * (ell * point + scratch)
        assert kernels.WS4_G1_NODE_BLOCKS * (nodes_smem + 1024) <= kernels.SMEM_SM
        assert kernels.WS4_G1_NODE_BLOCKS * 32 * 112 <= 65536
    else:
        assert (G, nodes_smem) == (Kp, 0)
    assert 1 <= warps <= kernels.WS4_G1_TOP_WARPS
    assert smem == (G + 1) // 2 * point + warps * padds * scratch
    assert 2 * (smem + 1024) <= kernels.SMEM_SM and 2 * warps * 32 * 128 <= 65536
    if (Kp, lanes) in WS4_G1_PATH_G:
        assert G == WS4_G1_PATH_G[(Kp, lanes)]


def test_window_sum4_g1_geometry_raises():
    point, per_warp = kernels.POINT_BYTES[CURVE], 5 * kernels.COOP_SCRATCH_BYTES[CURVE]
    odd = (kernels.SMEM_BLOCK_MAX - per_warp) // point * 2 + 1  # an odd Kp: one node a point
    with pytest.raises(ValueError, match="shared memory"):
        kernels.window_sum4_g1_geometry(odd, 4, H100_SMS)
    assert kernels.window_sum4_g1_geometry(odd - 2, 4, H100_SMS)[0] == odd - 2
    with pytest.raises(ValueError, match="powers of two"):
        kernels.window_sum4_g1_geometry(352, 4, H100_SMS, groups=4)
    with pytest.raises(ValueError, match="points and lanes"):
        kernels.window_sum4_g1_geometry(0, 4, H100_SMS)
