"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. the card (``nvidia-smi`` and torch's view of it);
2. the build of the CUDA kernels from ``libzkp_tpu_torch/csrc`` (timed);
3. each kernel (window_sum, horner, pair_add) against its plain PyTorch
   version on the card at the main path's shapes, both timed with CUDA events;
4. the main path: ``prove_range_batch`` of 256 range proofs (512 prover
   lanes; T1/T2 and the L/R MSMs at 1024 lanes) with the launch counters
   zeroed just before and read just after, then warm batches timed, a sample
   of proofs verified by the port's host verifier, and 4 lanes held byte for
   byte against the port's host prover under injected randomness;
5. the kernels line, the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line. Without a CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import torch

N_TRIPLES = 256       # range proofs per batch: 512 prover lanes
KP = 160              # padded basis of [B_blinding] + G(64) + H(64) + [B]
MSM_LANES = 1024      # T1||T2 and L||R MSMs run at twice the prover lanes
TIMED_BATCHES = 3
HOST_MEM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # IMAD results per clock per SM, compute capability 9.0
PADD_MACS = 9 * (24 * 24 + 26 * 24)    # 9 products of 576 conv + 624 fold multiply-adds
PDOUBLE_MACS = 8 * (24 * 24 + 26 * 24)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(macs: float, nbytes: float, int_rate: float):
    t_ops = macs / int_rate * 1e3
    t_bytes = nbytes / HOST_MEM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(dev, int_rate: float) -> list:
    """Phase 3: each kernel against its plain version at the path's shapes."""
    import numpy as np

    from libzkp_tpu_torch.ops import curve, ed25519 as ed, kernels

    eng = curve.edwards_engine()
    C, n = eng.coords, eng.n
    rng = random.Random(20261016)
    consts = torch.from_numpy(eng.consts_np).to(dev)

    # a relaxed multiples table of KP random curve points, built with the
    # plain table-add chain (kernel launches here would not be the path's)
    pts = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(KP)]
    baseT = torch.from_numpy(np.ascontiguousarray(np.transpose(eng.encode_points(pts), (1, 2, 0)))).to(dev)
    acc = eng.identity(KP, dev)
    rows = [acc]
    for _ in range(255):
        acc = kernels.pair_add_plain(consts, acc, baseT)
        rows.append(acc)
    table = torch.stack(rows).permute(3, 0, 1, 2).reshape(KP * 256, C, n).to(torch.int16).contiguous()
    digits = torch.randint(0, 256, (KP, MSM_LANES), generator=torch.Generator().manual_seed(7),
                           dtype=torch.int32).to(dev)

    def point_err(a, b) -> int:
        """Largest residue mod p of the projective cross-products
        X1*Z2 - X2*Z1, Y1*Z2 - Y2*Z1, T1*Z2 - T2*Z1 between the lanes of
        ``a`` and ``b`` (each (C, n, B)) and of the extended-coordinate
        invariant T*Z - X*Y within each lane: 0 when every lane of ``a`` is
        the same valid point as in ``b``."""
        P = ed.P

        def pts(t):
            return eng.decode_points(np.transpose(t.cpu().numpy(), (2, 0, 1)))

        err = 0
        for (X1, Y1, Z1, T1), (X2, Y2, Z2, T2) in zip(pts(a), pts(b), strict=True):
            err = max(err, (X1 * Z2 - X2 * Z1) % P, (Y1 * Z2 - Y2 * Z1) % P,
                      (T1 * Z2 - T2 * Z1) % P, (T1 * Z1 - X1 * Y1) % P, (T2 * Z2 - X2 * Y2) % P)
        return err

    results = []
    ws_k = kernels.window_sum(consts, table, digits)
    ws_p = kernels.window_sum_plain(consts, table, digits)
    torch.cuda.synchronize()
    err = point_err(ws_k, ws_p)
    if err != 0:
        raise AssertionError(f"window_sum disagrees with its plain version (point err {err})")
    t_k = cuda_ms(lambda: kernels.window_sum(consts, table, digits), 20)
    t_p = cuda_ms(lambda: kernels.window_sum_plain(consts, table, digits), 3)
    b_ms, b_by = bound((KP - 1) * PADD_MACS * MSM_LANES,
                       table.numel() * 2 + digits.numel() * 4 + C * n * MSM_LANES * 4, int_rate)
    results.append(dict(name="window_sum", route="cuda", source="libzkp_tpu_torch/csrc/window_sum.cu",
                        replaces="libzkp_tpu/ops/curve_jax.py:626",
                        max_abs_err=float(err), tolerance="point equality (X, Y, T cross-products with Z and T*Z = X*Y, mod p)",
                        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        shape=f"table ({KP * 256},{C},{n}) i16, digits ({KP},{MSM_LANES}) i32"))

    acc_in, wsum = ws_k, ws_p
    h_k = kernels.horner(consts, acc_in, wsum)
    h_p = kernels.horner_plain(consts, acc_in, wsum)
    torch.cuda.synchronize()
    err = int((h_k - h_p).abs().max())
    if err != 0:
        raise AssertionError(f"horner limbs differ from its plain version (max {err})")
    t_k = cuda_ms(lambda: kernels.horner(consts, acc_in, wsum), 50)
    t_p = cuda_ms(lambda: kernels.horner_plain(consts, acc_in, wsum), 5)
    b_ms, b_by = bound((8 * PDOUBLE_MACS + PADD_MACS) * MSM_LANES, 3 * C * n * MSM_LANES * 4, int_rate)
    results.append(dict(name="horner", route="cuda", source="libzkp_tpu_torch/csrc/horner.cu",
                        replaces="libzkp_tpu/ops/curve_jax.py:431",
                        max_abs_err=float(err), tolerance="exact limbs",
                        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        shape=f"acc, wsum ({C},{n},{MSM_LANES}) i32"))

    p = table.view(KP, 256, C, n)[:, 7].permute(1, 2, 0).to(torch.int32).contiguous()
    q = table.view(KP, 256, C, n)[:, 200].permute(1, 2, 0).to(torch.int32).contiguous()
    a_k = kernels.pair_add(consts, p, q)
    a_p = kernels.pair_add_plain(consts, p, q)
    torch.cuda.synchronize()
    err = int((a_k - a_p).abs().max())
    if err != 0:
        raise AssertionError(f"pair_add limbs differ from its plain version (max {err})")
    t_k = cuda_ms(lambda: kernels.pair_add(consts, p, q), 200)
    t_p = cuda_ms(lambda: kernels.pair_add_plain(consts, p, q), 20)
    b_ms, b_by = bound(PADD_MACS * KP, 3 * C * n * KP * 4, int_rate)
    results.append(dict(name="pair_add", route="cuda", source="libzkp_tpu_torch/csrc/pair_add.cu",
                        replaces="libzkp_tpu/ops/curve_jax.py:482",
                        max_abs_err=float(err), tolerance="exact limbs",
                        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        shape=f"p, q ({C},{n},{KP}) i32"))
    for r in results:
        emit({"phase": "kernel_check", **r})
    return results


def main_path(dev) -> dict:
    """Phase 4: 256 range proofs through the port's entry point."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import bulletproofs as bp
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend
    from libzkp_tpu_torch.ops import ed25519 as ed, kernels

    rng = random.Random(1016)
    triples = [((1 << 63) + 12345, 0, (1 << 64) - 1)]
    while len(triples) < N_TRIPLES:
        lo = rng.randrange(0, 1 << 62)
        hi = lo + rng.randrange(0, 1 << 62)
        triples.append((rng.randint(lo, hi), lo, hi))

    kernels.reset_launches()
    t0 = time.perf_counter()
    envs = zkp.prove_range_batch(triples, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = kernels.launches()
    want = {"pair_add": 255, "window_sum": 32 * 10, "horner": 32 * 10}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path needs {want}")
    if len(envs) != N_TRIPLES or any(not isinstance(e, bytes) or len(e) < 1400 for e in envs):
        raise AssertionError("prove_range_batch returned malformed envelopes")
    emit({"phase": "main_path_cold", "range_proofs": N_TRIPLES, "prover_lanes": 2 * N_TRIPLES,
          "seconds": cold_s, "launches": counts})

    batch_s = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        zkp.prove_range_batch(triples, device=dev)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    ms_batch = sum(batch_s) / len(batch_s) * 1e3  # mean over every timed batch
    emit({"phase": "main_path_warm", "batch_ms": [s * 1e3 for s in batch_s],
          "ms_per_batch": ms_batch, "ms_per_range_proof": ms_batch / N_TRIPLES})

    sample = list(range(0, N_TRIPLES, max(1, N_TRIPLES // 8)))[:8]
    t0 = time.perf_counter()
    for i in sample:
        value, lo, hi = triples[i]
        if not zkp.verify_range(envs[i], lo, hi):
            raise AssertionError(f"range proof {i} does not verify")
    bad = bytearray(envs[sample[1]])
    bad[len(bad) // 2] ^= 1
    if zkp.verify_range(bytes(bad), *triples[sample[1]][1:]):
        raise AssertionError("a tampered proof verified")
    emit({"phase": "verify_sample", "verified": len(sample), "tamper_rejected": True,
          "seconds": time.perf_counter() - t0})

    # byte-exactness: the device batch under seeded randomness against the
    # host golden prover for 4 lanes
    seeded = random.Random(99)
    insts = []
    for value, lo, hi in triples:
        insts += BulletproofsBackend.prepare_range_bits(value, lo, hi, 64)[0]
    per = (2 * 64 + 4) * 64
    rand = seeded.randbytes(per * len(insts))
    dev_res = bp._prove_batch_fixed_n(insts, 64, rand=rand, device=dev)
    lanes = sorted({0, 1, len(insts) // 2 + 1, len(insts) - 1})
    saved = bp._random_scalar
    try:
        for lane in lanes:
            draws = iter(
                ed.scalar_from_bytes_mod_order_wide(rand[per * lane + 64 * s : per * lane + 64 * s + 64])
                for s in range(2 * 64 + 4)
            )
            bp._random_scalar = lambda d=draws: next(d)
            # the device prover read the transcripts without advancing them
            t, value, blinding, n = insts[lane]
            proof, V = bp.prove_single(t, value, blinding, n)
            if proof.to_bytes() != dev_res[lane][0].to_bytes() or V != dev_res[lane][1]:
                raise AssertionError(f"lane {lane}: device proof differs from the host prover")
    finally:
        bp._random_scalar = saved
    emit({"phase": "byte_exact", "lanes": lanes, "proof_bytes": 672, "identical": True})
    return {"counts": counts, "ms_per_batch": ms_batch}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from libzkp_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    name_power = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(dev)
    int_rate = props.multi_processor_count * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    emit({"phase": "card", "nvidia_smi": name_power, "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sm_count": props.multi_processor_count,
          "max_sm_clock_mhz": sm_clock_mhz, "int32_mac_per_s": int_rate,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels.build()
    ptxas = {
        n: [ln.strip() for ln in (kernels.BUILD_DIR / f"{n}.log").read_text().splitlines()
            if "registers" in ln or "spill" in ln]
        for n in kernels.SOURCES
        if (kernels.BUILD_DIR / f"{n}.log").exists()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    checks = check_kernels(dev, int_rate)
    path = main_path(dev)

    emit({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": path["counts"][r["name"]]}
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in checks
    ]})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
