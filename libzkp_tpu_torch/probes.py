"""Probes of the field product and the point addition that every MSM kernel
inlines, run on the card's production device functions
(``csrc/fold_curves.cuh`` through ``csrc/probes.cu`` and ``csrc/pair_add.cu``).

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
from .ops.weierstrass import get_engine

DISTINCT = 64          # distinct operands, tiled over the lanes
CHAIN_R = 64           # P2: chained additions per lane
CHAIN_LANES = 512
MUL_LANES = 1 << 20    # P4
ADD_LANES = 1 << 18    # P5
MUL_MACS = 24 * 24 + 26 * 24  # one field product: conv + fold multiply-adds
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


def run(device=None, *, chain_lanes: int = CHAIN_LANES, mul_lanes: int = MUL_LANES,
        add_lanes: int = ADD_LANES) -> list:
    """P2, P4 (both fields) and P5 on ``device`` (default: the CUDA card)."""
    dev = resolve(device)
    return [padd_chain_probe(dev, lanes=chain_lanes),
            fe_mul_probe(dev, "ed25519", mul_lanes),
            fe_mul_probe(dev, "bn254_g1", mul_lanes),
            padd_probe(dev, add_lanes)]


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
