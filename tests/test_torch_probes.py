"""The plain versions of the probe kernels (P2 ``padd_chain``, P4
``fe_mul``) against the JAX package's point engine and field ops, those of
P6 ``mont_mul``, P7 ``mont_padd``, P1 ``fold_ablate`` and P3
``padd_f32_chain`` against the JAX formulas of the TPU probe scripts, all
against the host's integer and point arithmetic, and
``libzkp_tpu_torch.probes`` end to end on the CPU at tiny sizes; the
designs of the P3, P4 and P7 kernels (their constants written into the
code and their schedules) against the plain versions."""

from __future__ import annotations

import importlib.util
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from libzkp_tpu.ops import curve_jax as cj
from libzkp_tpu.ops import limbfold as jlimbfold
from libzkp_tpu_torch import probes
from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops.limb import _limbs_to_int, get_context
from libzkp_tpu_torch.ops.limbfold import FieldOps
from libzkp_tpu_torch.ops.weierstrass import get_engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_padd_chain_plain_matches_jax_padd_loop():
    """R = 4 chained additions over 8 lanes: the limbs of a loop of JAX
    ``EdwardsEngine.padd``."""
    consts, p, q, _, _ = probes.chain_inputs("cpu", lanes=8)
    got = kernels.padd_chain(consts, p, q, 4)
    jeng = cj.edwards_engine()
    jc = jnp.asarray(jeng.consts_np)
    want, jq = jnp.asarray(p.numpy()), jnp.asarray(q.numpy())
    for _ in range(4):
        want = jeng.padd(jc, want, jq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("curve", ["ed25519", "bn254_g1"])
def test_fe_mul_plain_matches_jax_field_ops(curve):
    """Products of canonical and of relaxed operands (a chained product, as
    the kernels feed them): the limbs of JAX ``limbfold.FieldOps.mul``, and
    a*b mod p."""
    consts, a, b, av, bv = probes.mul_inputs("cpu", curve, lanes=96)
    got = kernels.fe_mul(consts, a, b, curve=curve)
    relaxed = kernels.fe_mul(consts, got, a, curve=curve)
    ops = jlimbfold.FieldOps(get_engine(curve).n, jnp.asarray(consts.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ops.mul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))
    np.testing.assert_array_equal(relaxed.numpy(),
                                  np.asarray(ops.mul(jnp.asarray(got.numpy()), jnp.asarray(a.numpy()))))
    ctx = get_engine(curve).ctx
    vals = ctx.decode(relaxed.numpy().T)
    for i in range(96):
        x, y = av[i % probes.DISTINCT], bv[i % probes.DISTINCT]
        assert vals[i] == x * y % ctx.p * x % ctx.p


def test_probes_run_end_to_end_on_cpu(capsys):
    """Every probe runs its plain version, checks it against the host and
    reports no device time."""
    out = probes.run("cpu", chain_lanes=8, mul_lanes=64, add_lanes=80)
    assert [(r["probe"], r["name"]) for r in out] == [
        ("P2", "padd_chain"), ("P4", "fe_mul"), ("P4", "fe_mul_bn254_g1"), ("P5", "pair_add"),
        ("P6", "mont_mul"), ("P7", "mont_padd"),
        *(("P1", f"fold_ablate_{v}") for v in kernels.ABLATE_VARIANTS),
        ("P3", "padd_f32_chain")]
    assert all(r["ms"] is None for r in out)
    assert out[0]["macs"] == 9 * probes.MUL_MACS * probes.CHAIN_R * 8
    assert out[-1]["max_abs_limb"] <= probes.F32_HALF + 32
    assert not any(kernels.launches().values())
    assert probes.main(["--device", "cpu", "--chain-lanes", "4", "--mul-lanes", "8",
                        "--add-lanes", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 + len(out) and '"device": "cpu"' in lines[0]


def test_probe_wrappers_take_cpu_or_cuda_only():
    for call in (
        lambda: kernels.padd_chain(*(torch.empty(s, dtype=torch.int32, device="meta")
                                     for s in ((28, 24), (4, 24, 8), (4, 24, 8))), 4),
        lambda: kernels.fe_mul(*(torch.empty(s, dtype=torch.int32, device="meta")
                                 for s in ((27, 24), (24, 8), (24, 8))), curve="bn254_g1"),
    ):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_probe_inputs_tile_distinct_operands():
    """Lane i holds operand i % DISTINCT, as the TPU scripts tiled theirs."""
    _, a, _, av, _ = probes.mul_inputs("cpu", "ed25519", lanes=130)
    ctx = get_engine("ed25519").ctx
    vals = ctx.decode(a.numpy().T)
    assert vals == [av[i % probes.DISTINCT] for i in range(130)]
    rng = random.Random(0)
    assert probes._points(rng, 2) != probes._points(rng, 2)


# ---------------------------------------------------------------------------
# P4's BN254 kernel (csrc/bn254_fq.cuh bn_fq_mul): BN254 Fq's constants in
# the code
# ---------------------------------------------------------------------------


def _bn_fq_table() -> np.ndarray:
    """The ONE and FOLD rows written into bn_fq_mul (``bnfq::CONSTS``)."""
    text = (kernels.CSRC / "bn254_fq.cuh").read_text()
    body = re.search(r"CONSTS\[[^]]*\]\[[^]]*\] = \{(.*?)\n\};", text, re.S).group(1)
    return np.array([[int(v) for v in row.split(",")] for row in re.findall(r"\{([^{}]*)\}", body)],
                    dtype=np.int64)


def test_bn_fq_mul_constants_are_the_consts_block():
    """The 27 rows in the CUDA source are the bn254_g1 consts block's ONE
    and FOLD[0..25], row for row: 21 + 564 nonzero limbs."""
    table = _bn_fq_table()
    np.testing.assert_array_equal(table, get_engine("bn254_g1").consts_np[:27])
    assert table.shape == (27, 24)
    assert np.count_nonzero(table[0]) == 21 and np.count_nonzero(table[1:]) == 564


def _bn_fq_mul(table: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """bn_fq_mul's sums on (n, L) limbs in int64, nonzero terms only, in
    the kernel's order: the convolution row i by row i, two no-wrap passes
    (the top carry dropped), the fold t[i] + t[n + k] * FOLD[k][i] k by k,
    three wrap carries adding top * ONE[i]. Asserts that every value on
    the way fits int32, as the kernel's int32 sums need."""
    n = a.shape[0]
    one, fold = table[0], table[1:]

    def fits(x):
        assert np.abs(x).max() < 2**31
        return x

    a, b = a.astype(np.int64), b.astype(np.int64)
    t = np.zeros((2 * n + 2, a.shape[1]), np.int64)
    for i in range(n):
        t[i:i + n] = fits(t[i:i + n] + a[i] * b)
    for _ in range(2):
        hi = t >> 12
        t = t & 4095
        t[1:] += hi[:-1]
    r = t[:n].copy()
    for i in range(n):
        for k in np.flatnonzero(fold[:, i]):
            r[i] = fits(r[i] + t[n + k] * fold[k, i])
    for _ in range(3):
        top, hi = r[-1] >> 12, r >> 12
        r = r & 4095
        r[1:] += hi[:-1]
        for i in np.flatnonzero(one):
            r[i] = fits(r[i] + top * one[i])
    return r


@pytest.mark.parametrize("case", ["canonical", "padd_interval", "chained"])
def test_bn_fq_mul_sums_give_fold_product_limbs(case):
    """bn_fq_mul's sums over the source's table equal FieldOps.mul's limbs
    for canonical operands, for operands across the G1 padd-output interval
    [-7643, 11737] and for a product of a product (relaxed operands, as P4's
    chained check feeds the kernel)."""
    n = 24
    consts = torch.from_numpy(get_engine("bn254_g1").consts_np)
    f = FieldOps(n, consts)
    rng = np.random.default_rng(["canonical", "padd_interval", "chained"].index(case))
    lo, hi = (-7643, 11738) if case == "padd_interval" else (0, 4096)
    a, b = (rng.integers(lo, hi, (n, 256)).astype(np.int32) for _ in range(2))
    if case == "chained":
        a = f.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = f.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_bn_fq_mul(_bn_fq_table(), a, b), want)


def test_chip_smoke_sass_counts_reads_cuobjdump_listing(monkeypatch):
    """chip_smoke's SASS count (the check that BN254 Fq's kernel multiplies
    by immediates and reads no constant bank 3): per named kernel, every
    instruction, plain IMADs, IMADs with an immediate, LDCs and bank-3
    operands; other kernels and the encoding comments are skipped."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    listing = """
\t\tFunction : _ZN12_GLOBAL__N_113fe_mul_kernelI9BnProductEEvPKiS3_Pii
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD R5, R2, 0xd76, RZ ;      /* 0x00000d7602057824 */
        /*0020*/              @!P0 IMAD R5, R2, c[0x3][0x10], R5 ;  /* 0x000c000002057a24 */
        /*0030*/                   IMAD.MOV.U32 R5, RZ, RZ, 0x1 ;   /* 0x00000001ff057424 */
        /*0040*/                   IMAD R6, R2, R3, R5 ;          /* 0x0000000302067224 */
\t\tFunction : _Z17coop_chain_kernelI6EdCoopEvPKiS2_Piii
        /*0000*/                   IMAD R5, R2, 0x5, RZ ;         /* 0x0000000502057824 */
"""
    monkeypatch.setattr(smoke.subprocess, "run", lambda *a, **k: type("R", (), {"stdout": listing}))
    monkeypatch.setattr(kernels, "build", lambda: {"probes": "libprobes.so"})
    got = smoke.sass_counts("probes", ("fe_mul_kernel",))
    assert got == {"_ZN12_GLOBAL__N_113fe_mul_kernelI9BnProductEEvPKiS3_Pii": {
        "instructions": 5, "imad": 3, "imad_immediate": 1, "ldc": 1, "const_bank3": 1}}


# ---------------------------------------------------------------------------
# P6, P7, P1, P3: the plain versions against the TPU scripts' JAX formulas
# ---------------------------------------------------------------------------


def _script(name: str):
    """A TPU probe script of ``scripts/`` as a module (its JAX formulas run
    eagerly on the CPU; nothing here calls ``pallas_call``)."""
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mont_mul_plain_matches_bench_pallas_mul():
    """P6: the script's field ops (``make_field``, (n, lanes) limbs-major)
    on its random limbs give the limbs of ``mont_mul_plain`` on the rows,
    and a * b * R^-1 mod p."""
    consts, a, b = probes.mont_mul_inputs("cpu", lanes=96)
    ctx = get_context(ed.P)
    mm, _, _, _ = _script("bench_pallas_mul").make_field(ctx.n, np.int32(ctx.ninv))(
        jnp.asarray(consts.numpy()))
    got = kernels.mont_mul(consts, a, b)
    np.testing.assert_array_equal(got.numpy().T, np.asarray(mm(jnp.asarray(a.numpy().T),
                                                              jnp.asarray(b.numpy().T))))
    rinv = pow(ctx.R, -1, ctx.p)
    assert ctx.decode(got[:5]) == [_limbs_to_int(x) * _limbs_to_int(y) * rinv % ctx.p
                                   for x, y in zip(a[:5].numpy(), b[:5].numpy())]


def test_mont_padd_plain_matches_point_add_val():
    """P7: ``point_add_val`` of the script (written out here: it is local
    to the script's ``main``) on the script's field ops gives the limbs of
    ``mont_padd_plain``; decoded and times R^-1, the host's ``point_add``."""
    consts, p, q, ps, qs = probes.mont_padd_inputs("cpu", lanes=70)
    ctx = get_context(ed.P)
    jc = jnp.asarray(consts.numpy())
    mm, add, sub, _ = _script("bench_pallas_mul").make_field(ctx.n, np.int32(ctx.ninv))(jc[:3])
    X1, Y1, Z1, T1 = jnp.asarray(p.numpy())
    X2, Y2, Z2, T2 = jnp.asarray(q.numpy())
    two_d = jc[3][:, None]
    A = mm(sub(Y1, X1), sub(Y2, X2))
    B = mm(add(Y1, X1), add(Y2, X2))
    C = mm(mm(T1, T2), two_d)
    zz = mm(Z1, Z2)
    D = add(zz, zz)
    E, F, G, H = sub(B, A), sub(D, C), add(D, C), add(B, A)
    want = jnp.stack([mm(E, F), mm(G, H), mm(F, G), mm(E, H)])
    got = kernels.mont_padd(consts, p, q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rinv = pow(ctx.R, -1, ctx.p)
    vals = ctx.decode(got[..., :3].permute(2, 0, 1))
    for i in range(3):
        pt = tuple(v * rinv % ctx.p for v in vals[4 * i:4 * i + 4])
        assert ed.point_equal(pt, ed.point_add(ps[i], qs[i]))


@pytest.mark.parametrize("variant", kernels.ABLATE_VARIANTS)
def test_fold_ablate_plain_matches_bench_ablate(variant, monkeypatch):
    """P1 at the port's n = 24: the script's ``conv_a`` / ``conv_b`` (its N
    set to 24) and its 5 wrap carries, fold and plain multiply-adds
    (written out here: they are local to its ``main``)."""
    ba = _script("bench_ablate")
    n = 24
    monkeypatch.setattr(ba, "N", n)
    monkeypatch.setattr(ba, "NC", 2 * n + 2)
    consts, a, b = probes.ablate_inputs("cpu", variant, lanes=64)
    got = kernels.fold_ablate(consts, a, b, variant=variant)
    c, ja = jnp.asarray(consts.numpy()), jnp.asarray(a.numpy())
    jb = None if b is None else jnp.asarray(b.numpy())
    if variant in ("conv", "conv8"):
        conv = ba.conv_a if variant == "conv" else ba.conv_b
        want = conv(ja, jb)[:n] + conv(ja, jb)[n:2 * n] * 0
    elif variant == "carry5":
        t = ja
        for _ in range(5):
            hi = t >> 12
            t = (t & 4095) + jnp.pad(hi[:-1, :], [(1, 0), (0, 0)]) + hi[-1:, :] * c[0][:, None]
        want = t
    elif variant == "fold":
        want = ja[:n]
        for i in range(n + 2):
            want = want + ja[n + i:n + i + 1, :] * c[1 + i][:, None]
    else:
        want = ja * jb[0:1, :]
        for j in range(1, n):
            want = want + ja * jb[j:j + 1, :]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(got.shape) == (n, 64)


def test_padd_f32_chain_plain_matches_bench_mxu_and_stays_exact():
    """P3: the consts equal the script's ``build_consts``; 64 chained
    additions of ``padd_f32_chain_plain`` give the values of ``bench_mxu``'s
    padd (written out here with the script's HIGHEST-precision dots: it is
    local to its function), and every partial sum of every dot (the sum of
    its terms' magnitudes) stays below 2^24, so float32 is exact in any
    summation order."""
    bp = _script("bench_pallas_padd")
    consts, p, q, _, _ = probes.f32_chain_inputs("cpu", lanes=8)
    NF = kernels.F32_NF
    Cm, FmT, Um, TWOD, _ = bp.build_consts()
    np.testing.assert_array_equal(consts.numpy()[0], Um[:, NF - 1])
    np.testing.assert_array_equal(consts.numpy()[1:NF + 3].T, FmT)
    np.testing.assert_array_equal(consts.numpy()[NF + 3], TWOD)
    np.testing.assert_array_equal(probes.to_balanced(12345 << 200), bp.to_balanced(12345 << 200, NF))

    def dot(x, y):
        return jax.lax.dot_general(x, y, (((1,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST,
                                   preferred_element_type=jnp.float32)

    worst = [0.0]
    C, FT, U = jnp.asarray(Cm), jnp.asarray(FmT), jnp.asarray(Um)

    def note(t):
        worst[0] = max(worst[0], float(jnp.max(t)))

    def carry(x):
        hi = (x + bp.RND) - bp.RND
        note(jnp.abs(x - hi) + dot(jnp.abs(U), jnp.abs(hi * bp.ITW)))
        return (x - hi) + dot(U, hi * bp.ITW)

    def carry_nw(T):
        hi = (T + bp.RND) - bp.RND
        return (T - hi) + jnp.pad((hi * bp.ITW)[:-1, :], ((1, 0), (0, 0)))

    def mul(x, y):
        O = (x[:, None, :] * y[None, :, :]).reshape(NF * NF, -1)
        note(dot(C, jnp.abs(O)))
        T = carry_nw(carry_nw(dot(C, O)))
        note(jnp.abs(T[:NF]) + dot(jnp.abs(FT), jnp.abs(T[NF:])))
        return carry(carry(carry(T[:NF] + dot(FT, T[NF:]))))

    twod = jnp.asarray(TWOD)[:, None]
    P_ = tuple(jnp.asarray(p.numpy()))
    X2, Y2, Z2, T2 = jnp.asarray(q.numpy())
    for _ in range(probes.CHAIN_R):
        X1, Y1, Z1, T1 = P_
        A = mul(Y1 - X1, Y2 - X2)
        B = mul(Y1 + X1, Y2 + X2)
        Cc = mul(mul(T1, T2), twod)
        zz = mul(Z1, Z2)
        D = zz + zz
        E, F, G, H = B - A, D - Cc, D + Cc, B + A
        P_ = (mul(E, F), mul(G, H), mul(F, G), mul(E, H))
    got = kernels.padd_f32_chain(consts, p, q, probes.CHAIN_R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.stack(P_)))
    assert worst[0] < 2**24, worst[0]
    assert float(got.abs().max()) <= probes.F32_HALF + 32


# ---------------------------------------------------------------------------
# P3's cooperative schedule (csrc/probes.cu padd_f32_coop_kernel)
# ---------------------------------------------------------------------------


def _f32_round_w(x: torch.Tensor) -> torch.Tensor:
    return (x + kernels.F32_RND) - kernels.F32_RND


F32_ONE_LIMBS = {0: 192, 1: 2}  # f32_mul's wrap constant (csrc/probes.cu)


def _f32_fold_limbs(k: int) -> dict:
    """f32_mul's nonzero limbs of FOLD row k."""
    return {k: 192, k + 1: 2} if k < 28 else {k - 28: -184, k - 27: 6}


def test_f32_mul_constants_are_the_nonzero_fold_limbs():
    """The fold and ONE written into P3's product are exactly the nonzero
    limbs of the consts block's (p = 2^255 - 19 in balanced 9-bit limbs)."""
    consts = probes.f32_consts()
    NF = kernels.F32_NF
    assert {i: int(v) for i, v in enumerate(consts[0]) if v} == F32_ONE_LIMBS
    for k, row in enumerate(consts[1:NF + 3]):
        assert {i: int(v) for i, v in enumerate(row) if v} == _f32_fold_limbs(k)
    assert sum(len(_f32_fold_limbs(k)) for k in range(NF + 2)) == 62


def _f32_mul_kernel_order(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, peak: list) -> torch.Tensor:
    """f32_mul's float operations on (NF, L) float32, in the kernel's
    order: the convolution's FMAs i by i (column i + j gets term (i, j)
    after every term of a smaller i), two no-wrap carries (T[k] - h[k]) +
    h[k - 1] / 2^W, the fold's nonzero FMAs k by k into s, then T[i] + s,
    three wrap carries (r[i] - h[i] 2^W) + (h[i - 1] + ONE[i] top).
    ``peak`` keeps the largest magnitude of every value on the way: below
    2^24, every FMA is exact and any order gives the same floats."""
    NF, NC = kernels.F32_NF, kernels.F32_NC
    one, fold = consts[0][:, None], consts[1:NF + 3]
    T = torch.zeros((NC, a.shape[1]), dtype=torch.float32)

    def note(x):
        peak[0] = max(peak[0], float(x.abs().max()))
        return x

    for i in range(NF):
        T[i:i + NF] = note(T[i:i + NF] + a[i] * b)
    for _ in range(2):
        h = _f32_round_w(T)
        T = note((T - h) + F.pad((h * kernels.F32_ITW)[:-1], (0, 0, 1, 0)))
    s = torch.zeros_like(a)
    for k in range(NF + 2):
        nz = list(_f32_fold_limbs(k))
        s[nz] = note(s[nz] + fold[k][nz][:, None] * T[NF + k])
    r = note(T[:NF] + s)
    for _ in range(3):
        top = _f32_round_w(r[NF - 1]) * kernels.F32_ITW
        h = _f32_round_w(r) * kernels.F32_ITW
        r = note((r - h * (1 << kernels.F32_W)) + (F.pad(h[:-1], (0, 0, 1, 0)) + one * top))
    return r


def _f32_coop_padd(consts: torch.Tensor, P: torch.Tensor, Q: torch.Tensor, peak: list) -> torch.Tensor:
    """padd_f32_coop_kernel's two rounds, thread by thread: round 1, thread
    g's product of (Y1 - X1, Y2 - X2), (Y1 + X1, Y2 + X2), (T1, T2), (Z1,
    Z2), then thread 2's C = (T1 T2) 2d and thread 3's D = zz + zz into
    scratch rows A, B, C, D; round 2, thread g's (E, F), (G, H), (F, G), (E,
    H) from the rows (E = B - A, F = D - C, G = D + C, H = B + A) into
    coordinate g."""
    NF = kernels.F32_NF
    twod = consts[NF + 3][:, None].expand(NF, P.shape[-1])
    rows = []
    for g in range(4):
        if g < 2:
            sign = 1.0 if g else -1.0
            x, y = P[1] + sign * P[0], Q[1] + sign * Q[0]
        else:
            x, y = P[3 if g == 2 else 2], Q[3 if g == 2 else 2]
        x = _f32_mul_kernel_order(consts, x, y, peak)
        if g == 2:
            x = _f32_mul_kernel_order(consts, x, twod, peak)
        elif g == 3:
            x = x + x
        rows.append(x)

    def operand(v):
        hi = 3 if v in (1, 2) else 1
        return rows[hi] + (1.0 if v >= 2 else -1.0) * rows[hi - 1]

    return torch.stack([_f32_mul_kernel_order(consts, operand((0x0120 >> 4 * g) & 15),
                                              operand((0x3231 >> 4 * g) & 15), peak) for g in range(4)])


def test_padd_f32_coop_schedule_gives_plain_limbs_and_stays_exact():
    """P3's kernel schedule over R = 64 chained additions at 8 lanes: every
    limb equals padd_f32_chain_plain's bit for bit, every value on the way
    stays below 2^24 (so the float32 FMAs are exact in the kernel's order),
    and the output limbs stay within F32_HALF + 32."""
    consts, p, q, _, _ = probes.f32_chain_inputs("cpu", lanes=8)
    peak = [0.0]
    acc = p
    for _ in range(probes.CHAIN_R):
        acc = _f32_coop_padd(consts, acc, q, peak)
    want = kernels.padd_f32_chain_plain(consts, p, q, probes.CHAIN_R)
    assert torch.equal(acc.view(torch.int32), want.view(torch.int32))
    assert peak[0] < 2**24, peak[0]
    assert float(acc.abs().max()) <= probes.F32_HALF + 32


# ---------------------------------------------------------------------------
# P7's kernel (csrc/probes.cu mont_padd_kernel, csrc/mont.cuh Mont25519)
# ---------------------------------------------------------------------------

def _constants(source: str, names) -> dict:
    """The integer constants ``names`` as a CUDA source defines them
    (``NAME = value``, decimal or hex)."""
    text = (kernels.CSRC / source).read_text()
    return {n: int(re.search(rf"\b{n} = (0x[0-9a-fA-F]+|\d+)", text).group(1), 0) for n in names}


MONT25519 = _constants("mont.cuh", ("P0", "P_MID", "P_TOP", "ONE0", "ONE1", "NINV"))
MP = _constants("probes.cu", ("A_ROWS", "B_ROWS", "O_ROWS", "TWOD", "STEPS"))


def test_mont25519_constants_are_the_fields_limbs():
    """p, R mod p and ninv written into P7's product are exactly the consts
    block's rows for p = 2^255 - 19 (``get_context(ed.P)`` and the probe's
    consts block): p's limbs 4077, 4095 x 20, 7; R mod p's two nonzero
    limbs; ninv."""
    ctx = get_context(ed.P)
    c = MONT25519
    assert ctx.n == 22
    assert [int(v) for v in ctx.p_limbs] == [c["P0"]] + [c["P_MID"]] * 20 + [c["P_TOP"]]
    assert {i: int(v) for i, v in enumerate(ctx.one_mont) if v} == {0: c["ONE0"], 1: c["ONE1"]}
    assert ctx.ninv == c["NINV"] == 2587
    consts = probes.mont_padd_inputs("cpu", lanes=1)[0].numpy()
    np.testing.assert_array_equal(consts[:3], ctx.consts_np)
    assert int(consts[2, 0]) == c["NINV"]


def _n16(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel's int16 rows hold it: asserts that no limb leaves int16."""
    n16 = x.to(torch.int16)
    assert torch.equal(n16.to(torch.int32), x), "a limb left int16"
    return n16.to(torch.int32)


def _mont25519_carry(x: torch.Tensor) -> torch.Tensor:
    """mont_carry with Mont25519 on (22, L): the 20 zero limbs of R mod p
    left out."""
    top, hi = x[-1] >> 12, x >> 12
    r = x & 4095
    r[1:] += hi[:-1]
    r[0] += top * MONT25519["ONE0"]
    r[1] += top * MONT25519["ONE1"]
    return r


def _mont25519_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mont_mul<22> with Mont25519 on (22, L): the columns, the REDC with
    p's limbs and ninv as constants, three carries."""
    c = MONT25519
    n = a.shape[0]
    T = torch.zeros((2 * n, a.shape[1]), dtype=torch.int32)
    for j in range(n):
        T[j:j + n] += a * b[j]
    for i in range(n):
        m = ((T[i] & 4095) * c["NINV"]) & 4095
        T[i] += m * c["P0"]
        T[i + 1:i + n - 1] += m * c["P_MID"]
        T[i + n - 1] += m * c["P_TOP"]
        T[i + 1] += T[i] >> 12
    x = T[n:]
    for _ in range(3):
        x = _mont25519_carry(x)
    return x


def _mont_padd_steps(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """mont_padd_kernel's schedule: the lane's 8 int16 rows (p's X, Y, Z, T,
    then q's), the pair step (x, y) <- (carry(y - x), carry(y + x)) on rows
    (0, 1), (4, 5) before step 0 and (0, 1), (3, 2) before step 5, and the 9
    product steps from the kernel's row tables (operand row TWOD: the 2d
    row), step 4 doubled and carried, steps 5 to 8 into out."""
    rows = [_n16(x) for x in (*p, *q)]
    twod = _n16(consts[3][:, None].expand(-1, p.shape[-1]))
    out = [None] * 4

    def pair(xr, yr):
        x, y = rows[xr], rows[yr]
        rows[xr], rows[yr] = _n16(_mont25519_carry(y - x)), _n16(_mont25519_carry(y + x))

    for s in range(MP["STEPS"]):
        if s in (0, 5):
            for k in range(2):
                pair(4 * k if s == 0 else 3 * k, 4 * k + 1 if s == 0 else (2 if k else 1))
        ra, rb = (MP["A_ROWS"] >> 4 * s) & 15, (MP["B_ROWS"] >> 4 * s) & 15
        x = _mont25519_mul(rows[ra], twod if rb == MP["TWOD"] else rows[rb])
        if s == 4:
            x = _mont25519_carry(x + x)
        if s < 5:
            rows[(MP["O_ROWS"] >> 4 * s) & 15] = _n16(x)
        else:
            out[s - 5] = x
    return torch.stack(out)


def test_mont_padd_kernel_schedule_gives_plain_limbs():
    """P7's kernel schedule at 70 lanes of its probe's inputs: every stored
    row fits int16 and the limbs equal mont_padd_plain's (and so
    point_add_val's, above)."""
    consts, p, q, _, _ = probes.mont_padd_inputs("cpu", lanes=70)
    assert torch.equal(_mont_padd_steps(consts, p, q), kernels.mont_padd_plain(consts, p, q))
