"""Advanced misc: cache ops, metrics snapshot, benchmarks, cached and batched
wrappers, proof-chain validation, proof info, SNARK key-dir config.

Port of the JAX package's ``libzkp_tpu/advanced/misc.py`` (the loose
functions of the Rust reference's ``advanced/mod.rs:25-258``). Every prover
takes a keyword-only ``device=`` (default: the CUDA card; ``"cpu"`` runs the
plain PyTorch path).
"""

from __future__ import annotations

import math
from typing import Dict, List

from ..device import resolve
from ..models import snark_backend
from ..models.schemes import (
    consistency_proof,
    equality_proof,
    improvement_proof,
    range_proof,
    set_membership,
    threshold_proof,
)
from ..utils.envelope import Proof
from ..utils.errors import InvalidInput, ZkpError
from ..utils.performance import (  # noqa: F401 (verify_proofs_parallel: the API's name)
    Timer,
    generate_cache_key,
    get_global_cache,
    get_global_metrics,
    metrics_lock,
    record_operation_metric,
    verify_proofs_parallel,
)


def clear_cache() -> None:
    get_global_cache().clear()


def get_cache_stats() -> Dict[str, int]:
    return {"size": get_global_cache().size()}


_AVG_KEYS = [
    ("range_proof", "avg_range_proof_time_ms"),
    ("equality_proof", "avg_equality_proof_time_ms"),
    ("threshold_proof", "avg_threshold_proof_time_ms"),
    ("membership_proof", "avg_membership_proof_time_ms"),
    ("improvement_proof", "avg_improvement_proof_time_ms"),
    ("consistency_proof", "avg_consistency_proof_time_ms"),
]


def get_performance_metrics() -> Dict[str, float]:
    cache = get_global_cache()
    result: Dict[str, float] = {}
    with metrics_lock():
        metrics = get_global_metrics()
        result["cache_hit_rate"] = metrics.get_cache_hit_rate()
        result["cache_size"] = float(cache.size())
        result["cache_hits"] = float(metrics.cache_hits)
        result["cache_misses"] = float(metrics.cache_misses)
        for op, out_key in _AVG_KEYS:
            avg = metrics.get_average_time(op)
            if avg is not None:
                result[out_key] = avg * 1000.0
        for operation, count in metrics.operation_counts.items():
            result[f"{operation}_count"] = float(count)
        result["total_operations"] = float(sum(metrics.operation_counts.values()))
    return result


# canonical workloads (advanced/mod.rs:93-103), each on a device
_BENCH_WORKLOADS = {
    "range": lambda dev: range_proof.prove_range(50, 0, 100, device=dev),
    "equality": lambda dev: equality_proof.prove_equality(42, 42, device=dev),
    "threshold": lambda dev: threshold_proof.prove_threshold([10, 20, 30, 40], 50, device=dev),
    "membership": lambda dev: set_membership.prove_membership(25, [10, 20, 25, 30, 40], device=dev),
    "improvement": lambda dev: improvement_proof.prove_improvement(30, 50, device=dev),
    "consistency": lambda dev: consistency_proof.prove_consistency([10, 20, 30, 40, 50], device=dev),
}


def benchmark_proof_generation_numeric(
    proof_type: str, iterations: int, *, device=None
) -> Dict[str, float]:
    """``iterations`` proofs of ``proof_type``'s canonical workload on
    ``device``, timed. An iteration that fails with the library's own
    ``ZkpError`` counts as unsuccessful; any other error (a CUDA error, a
    failed kernel build or launch) propagates."""
    workload = _BENCH_WORKLOADS.get(proof_type)
    if workload is None:
        raise InvalidInput(f"unsupported proof type: {proof_type}")
    device = resolve(device)
    timer = Timer()
    times_ms: List[float] = []
    successful = 0
    for _ in range(iterations):
        timer.reset()
        try:
            workload(device)
        except ZkpError:
            continue
        elapsed = timer.elapsed()
        record_operation_metric(f"{proof_type}_proof", elapsed)
        times_ms.append(elapsed * 1000.0)
        successful += 1
    if successful == 0:
        raise InvalidInput("no successful proof generations")
    total = sum(times_ms)
    avg = total / successful
    variance = sum((x - avg) ** 2 for x in times_ms) / successful
    return {
        "iterations": float(iterations),
        "successful_iterations": float(successful),
        "success_rate": successful / iterations * 100.0,
        "total_time_ms": total,
        "avg_time_ms": avg,
        "min_time_ms": min(times_ms),
        "max_time_ms": max(times_ms),
        "std_dev_ms": math.sqrt(variance),
        "proofs_per_second": successful / (total / 1000.0),
        "throughput_ms_per_proof": total / successful,
    }


def benchmark_proof_generation(proof_type: str, iterations: int, *, device=None) -> Dict[str, str]:
    """String-valued variant for dict interop (advanced/mod.rs:204-215)."""
    numeric = benchmark_proof_generation_numeric(proof_type, iterations, device=device)
    results = {"proof_type": proof_type}
    for k, v in numeric.items():
        results[k] = str(v)
    return results


def prove_range_cached(value: int, min_v: int, max_v: int, *, device=None) -> bytes:
    """Range proof with caching support (advanced/mod.rs:175-190)."""
    cache = get_global_cache()
    params = f"{value}:{min_v}:{max_v}".encode()
    key = generate_cache_key("range_proof", params)
    cached = cache.get(key)
    if cached is not None:
        return cached
    timer = Timer()
    proof = range_proof.prove_range(value, min_v, max_v, device=device)
    record_operation_metric("range_proof", timer.elapsed())
    cache.put(key, proof)
    return proof


def prove_equality_advanced(val1: int, val2: int, *, device=None) -> bytes:
    return equality_proof.prove_equality(val1, val2, device=device)


def prove_threshold_optimized(values: List[int], threshold: int, *, device=None) -> bytes:
    return threshold_proof.prove_threshold(values, threshold, device=device)


def validate_proof_chain(proof_chain: List[bytes]) -> bool:
    """Framing-only validation of each element (advanced/mod.rs:224-235)."""
    for item in proof_chain:
        try:
            Proof.from_bytes(item)
        except ZkpError:
            return False
    return True


def get_proof_info(proof_bytes: bytes) -> Dict[str, int]:
    proof = Proof.from_bytes(proof_bytes)
    return {
        "version": proof.version,
        "scheme": proof.scheme,
        "proof_size": len(proof.proof),
        "commitment_size": len(proof.commitment),
    }


def set_snark_key_dir(path: str) -> bool:
    snark_backend.set_snark_key_dir(path)
    return True


def is_snark_setup_initialized() -> bool:
    return snark_backend.is_snark_initialized()
