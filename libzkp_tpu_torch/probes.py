"""Probes of the field products and the point additions that the kernels
inline, run on the card's production device functions
(``csrc/fold_curves.cuh`` and ``csrc/mont.cuh`` through ``csrc/probes.cu``,
``csrc/pair_add.cu`` and ``csrc/mont.cu``).

    python3 -m libzkp_tpu_torch.probes             # on the CUDA card
    python3 -m libzkp_tpu_torch.probes --device cpu --chain-lanes 8 \\
        --mul-lanes 64 --add-lanes 64              # plain versions, no timing

The counterparts of the JAX package's TPU probes:

* **P2** ``padd_chain`` (``scripts/bench_pallas_padd.py`` ``bench_current``):
  64 chained Edwards additions p <- p + q per lane over (4, 24, 512) int32,
  reported in ns per addition per lane and in µs per chained addition (the
  latency of one link of a chain of dependent additions).
* **P4** ``fe_mul`` (``scripts/bench_fold.py`` ``bench_field``): one fold
  product per lane over (24, 2^20) int32, for p = 2^255 - 19 and BN254 Fq,
  in M products/s. The TPU script laid its operands out with N = 22 limbs;
  the port runs n = 24, the layout every kernel uses.
* **P5** (``scripts/bench_fold.py`` ``main.pl_add``): one Edwards addition
  per lane over (4, 24, 2^18) int32, in M additions/s. This is exactly K3
  ``pair_add`` at that shape, so the probe launches K3.
* **P6** ``mont_mul`` (``scripts/bench_pallas_mul.py`` ``main.pallas_mul``):
  one 12-bit Montgomery product per row over (2^20, 22) int32 rows of random
  limbs in [-4096, 4096), p = 2^255 - 19, in M products/s. The kernel is the
  h pipeline's and the MiMC batch's, at their row-major layout; the TPU
  script laid its operands out limbs-major, (22, 2^20).
* **P7** ``mont_padd`` (``scripts/bench_pallas_mul.py`` ``main.pallas_add``):
  one Edwards addition in the Montgomery domain per lane over (4, 22, 2^18)
  int32, in M additions/s; checked by decoding, multiplying by R^-1 and
  comparing with the host's ``point_add``.
* **P1** ``fold_ablate`` (``scripts/bench_ablate.py`` ``run``): the parts of
  the fold product alone, one variant per instance (``conv``, ``conv8``,
  ``carry5``, ``fold``, ``mac``), at the port's n = 24 over (24, 2^20) int32
  ((50, 2^20) for ``fold``); the TPU script ran n = 22.
* **P3** ``padd_f32_chain`` (``scripts/bench_pallas_padd.py``
  ``bench_mxu``): 64 chained Edwards additions on float32 balanced 9-bit
  limbs over (4, 29, 512), checked projectively against the host and by the
  script's max |limb| <= HALF + 32.

Each probe checks its output against the host's integer arithmetic on every
distinct input (the lanes repeat 64 distinct operands, as the TPU scripts
tiled theirs) and times the kernel with CUDA events. On the CPU the wrappers
run their plain versions and nothing is timed: a CPU time is no device
number.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
from typing import Optional

import numpy as np
import torch

from .device import resolve
from .ops import ed25519 as ed, kernels
from .ops.limb import _limbs_to_int, get_context, ints_to_limb_rows
from .ops.weierstrass import get_engine

DISTINCT = 64          # distinct operands, tiled over the lanes
CHAIN_R = 64           # P2: chained additions per lane
CHAIN_LANES = 512
MUL_LANES = 1 << 20    # P4
ADD_LANES = 1 << 18    # P5
MUL_MACS = 24 * 24 + 26 * 24  # one field product: conv + fold multiply-adds
MONT_MACS = 2 * 22 * 22 + 22   # one Montgomery product: conv, REDC and its m
F32_FMAS = 29 * 29 + 29 * 31   # one f32 balanced product: conv and fold FMAs
F32_HALF = 1 << (kernels.F32_W - 1)
ITERS = 20             # timed launches per probe, after 2 warm-up launches


def _tile(rows: np.ndarray, lanes: int, dev) -> torch.Tensor:
    """(DISTINCT, ...) host limbs -> (..., lanes) int32, lane i holding
    operand i % DISTINCT."""
    reps = -(-lanes // rows.shape[0])
    t = np.tile(np.moveaxis(rows, 0, -1), reps)[..., :lanes]
    return torch.from_numpy(np.ascontiguousarray(t)).to(dev)


def _points(rng: random.Random, k: int):
    return [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(k)]


def chain_inputs(dev, lanes: int = CHAIN_LANES, seed: int = 2):
    """P2's consts, p and q lanes (4, n, lanes) and the host points."""
    eng = get_engine("ed25519")
    rng = random.Random(seed)
    ps, qs = _points(rng, DISTINCT), _points(rng, DISTINCT)
    consts = torch.from_numpy(eng.consts_np).to(dev)
    return consts, _tile(eng.encode_points(ps), lanes, dev), _tile(eng.encode_points(qs), lanes, dev), ps, qs


def mul_inputs(dev, curve: str, lanes: int = MUL_LANES, seed: int = 4):
    """P4's consts, a and b lanes (n, lanes) in the field of ``curve`` and
    the host values."""
    eng = get_engine(curve)
    rng = random.Random(seed)
    av = [rng.randrange(eng.ctx.p) for _ in range(DISTINCT)]
    bv = [rng.randrange(eng.ctx.p) for _ in range(DISTINCT)]
    consts = torch.from_numpy(eng.consts_np).to(dev)
    return consts, _tile(eng.ctx.encode_ints(av), lanes, dev), _tile(eng.ctx.encode_ints(bv), lanes, dev), av, bv


def add_inputs(dev, lanes: int = ADD_LANES, seed: int = 5):
    """P5's consts, p and q lanes (4, n, lanes) and the host points."""
    return chain_inputs(dev, lanes, seed)


def mont_mul_inputs(dev, lanes: int = MUL_LANES, seed: int = 6):
    """P6's consts (2^255 - 19) and a, b rows (lanes, 22) int32 of random
    limbs in [-4096, 4096), as the TPU script drew them."""
    ctx = get_context(ed.P)
    a, b = np.random.default_rng(seed).integers(-4096, 4096, (2, lanes, ctx.n), dtype=np.int32)
    return ctx.tensor("consts", dev), torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def mont_padd_inputs(dev, lanes: int = ADD_LANES, seed: int = 7):
    """P7's consts (p, R mod p, ninv, 2d * R mod p), p and q lanes
    (4, 22, lanes) of Montgomery coordinates, and the host points."""
    ctx = get_context(ed.P)
    rng = random.Random(seed)
    ps, qs = _points(rng, DISTINCT), _points(rng, DISTINCT)
    two_d = ints_to_limb_rows([ed.TWO_D * ctx.R % ctx.p], ctx.n)
    consts = torch.from_numpy(np.concatenate([ctx.consts_np, two_d])).to(dev)

    def enc(pts):
        rows = ints_to_limb_rows([c * ctx.R % ctx.p for pt in pts for c in pt], ctx.n)
        return _tile(rows.reshape(len(pts), 4, ctx.n), lanes, dev)

    return consts, enc(ps), enc(qs), ps, qs


def ablate_inputs(dev, variant: str, lanes: int = MUL_LANES, seed: int = 8):
    """P1's consts (the ed25519 fold block: ONE, FOLD) and operands of random
    limbs in [-4096, 4096): a (24, lanes), or (50, lanes) for ``fold``; b
    (24, lanes) for the two-operand variants, else None."""
    eng = get_engine("ed25519")
    rng = np.random.default_rng(seed)
    rows = 2 * eng.n + 2 if variant == "fold" else eng.n
    a = torch.from_numpy(rng.integers(-4096, 4096, (rows, lanes), dtype=np.int32)).to(dev)
    b = None
    if variant in ("conv", "conv8", "mac"):
        b = torch.from_numpy(rng.integers(-4096, 4096, (eng.n, lanes), dtype=np.int32)).to(dev)
    return torch.from_numpy(eng.consts_np).to(dev), a, b


def to_balanced(x: int, n: int = kernels.F32_NF) -> np.ndarray:
    """Non-negative x -> n balanced base-2^W digits in [-HALF, HALF)."""
    W = kernels.F32_W
    out = np.zeros(n, dtype=np.float64)
    for i in range(n):
        d = x & ((1 << W) - 1)
        x >>= W
        if d >= F32_HALF:
            d -= 1 << W
            x += 1
        out[i] = d
    assert x == 0
    return out


def from_balanced(v, p: int) -> int:
    return sum(int(round(float(c))) << (kernels.F32_W * i) for i, c in enumerate(v)) % p


def f32_consts() -> np.ndarray:
    """P3's (NF + 4, NF) float32 consts: ONE = 2^(W NF) mod p, FOLD[k] =
    2^(W (NF + k)) mod p for k < NF + 2, and 2d, as balanced limbs."""
    NF, W, p = kernels.F32_NF, kernels.F32_W, ed.P
    rows = [to_balanced((1 << (W * NF)) % p)]
    rows += [to_balanced((1 << (W * (NF + k))) % p) for k in range(NF + 2)]
    rows.append(to_balanced(ed.TWO_D))
    return np.stack(rows).astype(np.float32)


def f32_chain_inputs(dev, lanes: int = CHAIN_LANES, seed: int = 3):
    """P3's consts, p and q lanes (4, NF, lanes) float32 and the host
    points."""
    rng = random.Random(seed)
    ps, qs = _points(rng, DISTINCT), _points(rng, DISTINCT)

    def enc(pts):
        rows = np.stack([np.stack([to_balanced(c % ed.P) for c in pt]) for pt in pts])
        return _tile(rows.astype(np.float32), lanes, dev)

    return torch.from_numpy(f32_consts()).to(dev), enc(ps), enc(qs), ps, qs


def _decode_points(t: torch.Tensor):
    eng = get_engine("ed25519")
    return eng.decode_points(np.transpose(t[..., :DISTINCT].cpu().numpy(), (2, 0, 1)))


def _time_ms(fn, dev) -> Optional[float]:
    """Mean ms per call over ITERS calls after 2 warm-up calls, by CUDA
    events; None on the CPU."""
    if dev.type != "cuda":
        return None
    for _ in range(2):
        fn()
    torch.cuda.synchronize(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / ITERS


def padd_chain_probe(dev, R: int = CHAIN_R, lanes: int = CHAIN_LANES) -> dict:
    """P2: R chained additions per lane; checked against p + R*q on the host."""
    consts, p, q, ps, qs = chain_inputs(dev, lanes)
    out = kernels.padd_chain(consts, p, q, R)
    for got, a, b in zip(_decode_points(out), ps, qs):
        if not ed.point_equal(got, ed.point_add(a, ed.scalar_mul(R, b))):
            raise AssertionError("padd_chain: a lane is not p + R*q")
    ms = _time_ms(lambda: kernels.padd_chain(consts, p, q, R), dev)
    n = p.shape[1]
    return {"probe": "P2", "name": "padd_chain", "shape": [4, n, lanes], "chain": R, "ms": ms,
            "ns_per_padd_lane": None if ms is None else ms * 1e6 / (R * lanes),
            "us_per_chained_padd": None if ms is None else ms * 1e3 / R,
            "macs": 9 * MUL_MACS * R * lanes, "bytes": 3 * 4 * n * lanes * 4}


def fe_mul_probe(dev, curve: str, lanes: int = MUL_LANES) -> dict:
    """P4: one product per lane; checked against a*b mod p on the host."""
    consts, a, b, av, bv = mul_inputs(dev, curve, lanes)
    out = kernels.fe_mul(consts, a, b, curve=curve)
    ctx = get_engine(curve).ctx
    got = ctx.decode(out[:, :DISTINCT].cpu().numpy().T)
    if got != [x * y % ctx.p for x, y in zip(av, bv)][: len(got)]:
        raise AssertionError(f"fe_mul {curve}: a lane is not a*b mod p")
    ms = _time_ms(lambda: kernels.fe_mul(consts, a, b, curve=curve), dev)
    n = a.shape[0]
    return {"probe": "P4", "name": kernels.instance("fe_mul", curve), "shape": [n, lanes],
            "field": "2^255-19" if curve == "ed25519" else "BN254 Fq", "ms": ms,
            "m_products_per_s": None if ms is None else lanes / ms / 1e3,
            "macs": MUL_MACS * lanes, "bytes": 3 * n * lanes * 4}


def padd_probe(dev, lanes: int = ADD_LANES) -> dict:
    """P5: one addition per lane by K3; checked against p + q on the host."""
    consts, p, q, ps, qs = add_inputs(dev, lanes)
    out = kernels.pair_add(consts, p, q)
    for got, a, b in zip(_decode_points(out), ps, qs):
        if not ed.point_equal(got, ed.point_add(a, b)):
            raise AssertionError("pair_add: a lane is not p + q")
    ms = _time_ms(lambda: kernels.pair_add(consts, p, q), dev)
    n = p.shape[1]
    return {"probe": "P5", "name": "pair_add", "shape": [4, n, lanes], "ms": ms,
            "m_padds_per_s": None if ms is None else lanes / ms / 1e3,
            "macs": 9 * MUL_MACS * lanes, "bytes": 3 * 4 * n * lanes * 4}


def mont_mul_probe(dev, lanes: int = MUL_LANES) -> dict:
    """P6: one Montgomery product per row; checked against a * b * R^-1 mod
    p on the host."""
    consts, a, b = mont_mul_inputs(dev, lanes)
    out = kernels.mont_mul(consts, a, b)
    ctx = get_context(ed.P)
    r_inv = pow(ctx.R, -1, ctx.p)
    an, bn = a[:DISTINCT].cpu().numpy(), b[:DISTINCT].cpu().numpy()
    want = [_limbs_to_int(x) * _limbs_to_int(y) * r_inv % ctx.p for x, y in zip(an, bn)]
    if ctx.decode(out[:DISTINCT]) != want:
        raise AssertionError("mont_mul: a row is not a * b * R^-1 mod p")
    ms = _time_ms(lambda: kernels.mont_mul(consts, a, b), dev)
    return {"probe": "P6", "name": "mont_mul", "shape": [lanes, ctx.n], "field": "2^255-19",
            "ms": ms, "m_products_per_s": None if ms is None else lanes / ms / 1e3,
            "macs": MONT_MACS * lanes, "bytes": 3 * ctx.n * lanes * 4}


def mont_padd_probe(dev, lanes: int = ADD_LANES) -> dict:
    """P7: one Montgomery-domain addition per lane; decoded, times R^-1,
    checked against p + q on the host."""
    consts, p, q, ps, qs = mont_padd_inputs(dev, lanes)
    out = kernels.mont_padd(consts, p, q)
    ctx = get_context(ed.P)
    r_inv = pow(ctx.R, -1, ctx.p)
    vals = ctx.decode(out[..., :DISTINCT].permute(2, 0, 1))
    for i, (a, b) in enumerate(zip(ps[:lanes], qs)):
        got = tuple(v * r_inv % ctx.p for v in vals[4 * i : 4 * i + 4])
        if not ed.point_equal(got, ed.point_add(a, b)):
            raise AssertionError("mont_padd: a lane is not p + q")
    ms = _time_ms(lambda: kernels.mont_padd(consts, p, q), dev)
    return {"probe": "P7", "name": "mont_padd", "shape": [4, ctx.n, lanes], "ms": ms,
            "m_padds_per_s": None if ms is None else lanes / ms / 1e3,
            "macs": 9 * MONT_MACS * lanes, "bytes": 3 * 4 * ctx.n * lanes * 4}


def fold_ablate_probe(dev, variant: str, lanes: int = MUL_LANES) -> dict:
    """P1: one part of the fold product per lane; the first lanes checked
    against the plain version on the host's CPU."""
    consts, a, b = ablate_inputs(dev, variant, lanes)
    out = kernels.fold_ablate(consts, a, b, variant=variant)
    cut = (lambda t: None if t is None else t[:, :DISTINCT].cpu())
    want = kernels.fold_ablate_plain(consts.cpu(), cut(a), cut(b), variant=variant)
    if not torch.equal(out[:, :DISTINCT].cpu(), want):
        raise AssertionError(f"fold_ablate {variant}: a lane differs from the host's")
    ms = _time_ms(lambda: kernels.fold_ablate(consts, a, b, variant=variant), dev)
    n = consts.shape[1]
    return {"probe": "P1", "name": kernels.instance("fold_ablate", variant),
            "shape": list(a.shape), "ms": ms,
            "m_lanes_per_s": None if ms is None else lanes / ms / 1e3,
            "ops": ABLATE_OPS[variant](n) * lanes,
            "bytes": (a.numel() + (0 if b is None else b.numel()) + n * lanes) * 4}


# int32 operations per lane of each P1 variant at n limbs (a multiply-add, an
# and, a shift or an add counts one)
ABLATE_OPS = {
    "conv": lambda n: n * n + n,            # the columns, then + high * zero
    "conv8": lambda n: n * n + 8 * (2 * n + 2) + n,
    "carry5": lambda n: 5 * 4 * n,          # and, shift, add, multiply-add per limb
    "fold": lambda n: (n + 2) * n,
    "mac": lambda n: n * n,
}


def padd_f32_chain_probe(dev, R: int = CHAIN_R, lanes: int = CHAIN_LANES) -> dict:
    """P3: R chained float32 additions per lane; checked projectively against
    p + R*q on the host, and every limb within HALF + 32."""
    consts, p, q, ps, qs = f32_chain_inputs(dev, lanes)
    out = kernels.padd_f32_chain(consts, p, q, R)
    host = out[..., :DISTINCT].cpu().numpy().astype(np.float64)
    for i, (a, b) in enumerate(zip(ps[:lanes], qs)):
        got = tuple(from_balanced(host[c, :, i], ed.P) for c in range(4))
        if not ed.point_equal(got, ed.point_add(a, ed.scalar_mul(R, b))):
            raise AssertionError("padd_f32_chain: a lane is not p + R*q")
    max_limb = float(out.abs().max())
    if max_limb > F32_HALF + 32:
        raise AssertionError(f"padd_f32_chain: a limb is {max_limb}, above HALF + 32")
    ms = _time_ms(lambda: kernels.padd_f32_chain(consts, p, q, R), dev)
    return {"probe": "P3", "name": "padd_f32_chain", "shape": [4, kernels.F32_NF, lanes],
            "chain": R, "ms": ms, "max_abs_limb": max_limb,
            "ns_per_padd_lane": None if ms is None else ms * 1e6 / (R * lanes),
            "us_per_chained_padd": None if ms is None else ms * 1e3 / R,
            "fmas": 9 * F32_FMAS * R * lanes, "bytes": 3 * p.numel() * 4}


def run(device=None, *, chain_lanes: int = CHAIN_LANES, mul_lanes: int = MUL_LANES,
        add_lanes: int = ADD_LANES) -> list:
    """P2, P4 (both fields), P5, P6, P7, P1 (every variant) and P3 on
    ``device`` (default: the CUDA card). P6 and P1 run at ``mul_lanes``, P7
    at ``add_lanes``, P3 at ``chain_lanes``."""
    dev = resolve(device)
    return [padd_chain_probe(dev, lanes=chain_lanes),
            fe_mul_probe(dev, "ed25519", mul_lanes),
            fe_mul_probe(dev, "bn254_g1", mul_lanes),
            padd_probe(dev, add_lanes),
            mont_mul_probe(dev, mul_lanes),
            mont_padd_probe(dev, add_lanes),
            *(fold_ablate_probe(dev, v, mul_lanes) for v in kernels.ABLATE_VARIANTS),
            padd_f32_chain_probe(dev, lanes=chain_lanes)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--chain-lanes", type=int, default=CHAIN_LANES)
    ap.add_argument("--mul-lanes", type=int, default=MUL_LANES)
    ap.add_argument("--add-lanes", type=int, default=ADD_LANES)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    card = {"device": str(dev)}
    if dev.type == "cuda":
        card["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(card), flush=True)
    for r in run(dev, chain_lanes=args.chain_lanes, mul_lanes=args.mul_lanes,
                 add_lanes=args.add_lanes):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
