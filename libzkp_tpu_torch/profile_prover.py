"""Where the time of one batched range-proof prove goes, on the CUDA card.

    python3 -m libzkp_tpu_torch.profile_prover [--triples 256 [512 ...]]

For each batch size in ``--triples`` (range proofs per batch; twice that many
prover lanes) it proves one batch to warm up (the basis table is built on the
first), then a timed batch with each component of the prover wrapped in a
host timer that synchronizes the device before and after it, so every
component's wall time includes the device work it queued: host preparation
(commitments, transcripts), MSMs, Ristretto compression, transcript phases,
the scalar programs, and the rest. At the first size it then proves one
batch under ``torch.profiler``: device busy time by kernel, the number of
device operations, and the device's idle share of the wall time.

Prints one JSON line per part. Needs a CUDA device; it does not fall back to
the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import random
import time
from collections import defaultdict

import torch


def _triples(n: int):
    rng = random.Random(1016)
    out = [((1 << 63) + 12345, 0, (1 << 64) - 1)]
    while len(out) < n:
        lo = rng.randrange(0, 1 << 62)
        hi = lo + rng.randrange(0, 1 << 62)
        out.append((rng.randint(lo, hi), lo, hi))
    return out


def _wrap(owner, attr: str, label: str, spent: dict, depth: list):
    """Replace owner.attr by a timer that syncs the device around the call;
    only the outermost timed call counts, so nested components do not
    double count. Returns a function that puts the original back."""
    orig = vars(owner)[attr]
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        if depth[0]:
            return fn(*args, **kwargs)
        depth[0] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t0
            depth[0] -= 1

    setattr(owner, attr, timed)
    return lambda: setattr(owner, attr, orig)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--triples", type=int, nargs="+", default=[256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_prover needs a CUDA device")
    from . import prove_range_batch
    from .models import bp_device
    from .models.bulletproofs_backend import BulletproofsBackend
    from .ops import curve, keccak_device

    dev = torch.device("cuda", 0)
    spent: dict = defaultdict(float)
    depth = [0]
    components = [
        (BulletproofsBackend, "prepare_range_bits", "host_prepare"),
        (curve, "msm_windows", "msm"),
        (keccak_device.TranscriptDevice, "run_phase", "transcript"),
        (keccak_device.TranscriptDevice, "from_transcripts", "transcript"),
    ] + [(bp_device._Segs, name, f"seg_{name}")
         for name in ("setup", "after_x", "hc", "w", "ipp_pre", "ipp_post", "final", "compress")]
    restore = [_wrap(owner, attr, label, spent, depth) for owner, attr, label in components]
    for n in args.triples:
        triples = _triples(n)
        t0 = time.perf_counter()
        prove_range_batch(triples, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        spent.clear()
        t0 = time.perf_counter()
        prove_range_batch(triples, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        parts = {k: v * 1e3 for k, v in sorted(spent.items(), key=lambda kv: -kv[1])}
        parts["rest"] = total * 1e3 - sum(parts.values())
        print(json.dumps({"part": "components_ms", "device": torch.cuda.get_device_name(0),
                          "range_proofs": n, "prover_lanes": 2 * n, "warmup_s": warm_s,
                          "batch_ms": total * 1e3, "ms_per_range_proof": total * 1e3 / n,
                          **parts}), flush=True)
    for undo in restore:
        undo()

    # the first size again, without the timers' synchronizations, for the
    # wall time the profiler's device time is set against
    triples = _triples(args.triples[0])
    t0 = time.perf_counter()
    prove_range_batch(triples, device=dev)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove_range_batch(triples, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): host ops that launched
    # them would count the same device time again
    kernels = [
        (evt.key, evt.self_device_time_total, evt.count)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels) / 1e3
    print(json.dumps({
        "part": "profile", "range_proofs": len(triples), "batch_ms_unprofiled": plain_ms,
        "wall_ms_profiled": wall * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / plain_ms,
        "device_ops": sum(k[2] for k in kernels),
        "top": [{"name": k[0][:80], "device_ms": k[1] / 1e3, "calls": k[2]} for k in kernels[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
