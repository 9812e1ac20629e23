"""Proof cache, performance metrics, timers, batched verification.

Port of the JAX package's ``libzkp_tpu/utils/performance.py`` (the Rust
reference's ``utils/performance.rs``): TTL+LFU ``ProofCache`` (1000 entries
/ 3600 s), global metrics collector, per-process cache-key salt, ``Timer``,
and the proof-type-checked verifier of many proofs (performance.rs:246-294).

:func:`verify_proofs_parallel` batches by backend and runs the rest one
after another on the calling thread. It has no fork pool and no thread
pool: a process that has initialised CUDA must not touch the device from a
forked child, and the native tier's OpenMP team is the port's only host
parallelism (``native._team``).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .envelope import PROOF_VERSION, Proof
from .errors import ZkpError

# Per-process random salt so cache keys differ across processes
# (performance.rs:145-156).
_CACHE_KEY_PROCESS_SALT = os.urandom(32)


def _now_ms() -> float:
    return time.monotonic() * 1000.0


class ProofCache:
    """TTL cache with LFU-style eviction at capacity (not LRU)."""

    def __init__(self, max_size: int = 1000, ttl_seconds: int = 3600):
        self._lock = threading.Lock()
        self._cache: Dict[str, List] = {}  # key -> [data, created_ms, access_count]
        self.max_size = max_size
        self.ttl_ms = ttl_seconds * 1000.0

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                if _now_ms() - entry[1] < self.ttl_ms:
                    entry[2] += 1
                    record_global_cache_hit()
                    return entry[0]
                del self._cache[key]
        record_global_cache_miss()
        return None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            if len(self._cache) >= self.max_size:
                victim = min(self._cache.items(), key=lambda kv: kv[1][2])[0]
                del self._cache[victim]
            self._cache[key] = [bytes(data), _now_ms(), 1]

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()

    def size(self) -> int:
        with self._lock:
            return len(self._cache)


class PerformanceMetrics:
    def __init__(self):
        self.operation_counts: Dict[str, int] = {}
        self.operation_times: Dict[str, List[float]] = {}  # seconds
        self.cache_hits = 0
        self.cache_misses = 0

    def record_operation(self, operation: str, duration_s: float) -> None:
        self.operation_counts[operation] = self.operation_counts.get(operation, 0) + 1
        self.operation_times.setdefault(operation, []).append(duration_s)

    def record_cache_hit(self) -> None:
        self.cache_hits += 1

    def record_cache_miss(self) -> None:
        self.cache_misses += 1

    def get_average_time(self, operation: str) -> Optional[float]:
        times = self.operation_times.get(operation)
        if not times:
            return None
        return sum(times) / len(times)

    def get_cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


_global_cache: Optional[ProofCache] = None
_global_metrics: Optional[PerformanceMetrics] = None
_metrics_lock = threading.Lock()
_init_lock = threading.Lock()


def get_global_cache() -> ProofCache:
    global _global_cache
    with _init_lock:
        if _global_cache is None:
            _global_cache = ProofCache(1000, 3600)
        return _global_cache


def get_global_metrics() -> PerformanceMetrics:
    global _global_metrics
    with _init_lock:
        if _global_metrics is None:
            _global_metrics = PerformanceMetrics()
        return _global_metrics


def metrics_lock() -> threading.Lock:
    return _metrics_lock


def record_operation_metric(operation: str, duration_s: float) -> None:
    with _metrics_lock:
        get_global_metrics().record_operation(operation, duration_s)


def record_global_cache_hit() -> None:
    with _metrics_lock:
        get_global_metrics().record_cache_hit()


def record_global_cache_miss() -> None:
    with _metrics_lock:
        get_global_metrics().record_cache_miss()


def generate_cache_key(operation: str, params: bytes) -> str:
    """``{operation}:{hex}`` with the process salt mixed in (performance.rs:145-156)."""
    h = hashlib.sha256()
    h.update(_CACHE_KEY_PROCESS_SALT)
    h.update(operation.encode("utf-8"))
    h.update(bytes(params))
    return f"{operation}:{h.hexdigest()}"


class Timer:
    def __init__(self):
        self._start = time.monotonic()

    def elapsed(self) -> float:
        """Elapsed seconds."""
        return time.monotonic() - self._start

    def reset(self) -> None:
        self._start = time.monotonic()


# ---------------------------------------------------------------------------
# Verification of many proofs (performance.rs mod parallel)
# ---------------------------------------------------------------------------

_PROOF_TYPE_TO_SCHEME = {
    "range": 1,
    "equality": 2,
    "threshold": 3,
    "membership": 4,
    "improvement": 5,
    "consistency": 6,
}


def _verify_single_proof(proof_data: bytes, proof_type: str) -> bool:
    from ..models.schemes.dispatch import verify_proof_cryptographic

    try:
        proof = Proof.from_bytes(proof_data)
    except ZkpError:
        return False
    if proof.version != PROOF_VERSION:
        return False
    expected = _PROOF_TYPE_TO_SCHEME.get(proof_type)
    if expected is None or proof.scheme != expected:
        return False
    return verify_proof_cryptographic(proof)


def verify_proofs_parallel(proofs: Sequence[Tuple[bytes, str]]) -> List[bool]:
    """Verify ``(proof_bytes, proof_type)`` pairs; never raises on a
    malformed proof.

    The reference verifies with rayon work-stealing (performance.rs:251-258).
    Here the Bulletproofs-backed schemes (range, threshold, consistency) go
    to one random-linear-combination check (``batch_verify_groups``, the
    native RLC verifier, bisecting on failure), the Groth16 schemes to one
    batched pairing check per circuit (``SnarkBackend.verify_equality_batch``
    and ``verify_membership_batch``), and the rest (improvements, unknown
    type labels) one after another on the native verifiers.
    """
    from ..models.bulletproofs import batch_verify_groups
    from ..models.schemes.common import deserialize_embedded_set_prefix
    from ..models.snark_backend import MAX_SET_SIZE, SnarkBackend

    items = list(proofs)
    if len(items) <= 1:
        return [_verify_single_proof(d, t) for d, t in items]

    results: List[Optional[bool]] = [None] * len(items)
    bp_idx: List[int] = []
    bp_groups = []
    eq_idx: List[int] = []
    eq_entries = []
    mem_idx: List[int] = []
    mem_entries = []
    for i, (data, ptype) in enumerate(items):
        if ptype not in ("range", "threshold", "consistency", "equality", "membership"):
            continue
        try:
            proof = Proof.from_bytes(data)
        except ZkpError:
            results[i] = False
            continue
        if proof.version != PROOF_VERSION or proof.scheme != _PROOF_TYPE_TO_SCHEME[ptype]:
            results[i] = False
        elif ptype == "equality":
            if len(proof.commitment) != 32:
                results[i] = False
            else:
                eq_idx.append(i)
                eq_entries.append((proof.proof, proof.commitment))
        elif ptype == "membership":
            parsed = deserialize_embedded_set_prefix(proof.proof, MAX_SET_SIZE)
            if len(proof.commitment) != 32 or parsed is None or not parsed[1]:
                results[i] = False
            else:
                mem_idx.append(i)
                mem_entries.append((parsed[1], parsed[0], proof.commitment))
        else:
            try:  # a verifier's "never raise": malformed input is a rejected proof
                insts = _bulletproof_instances(proof)
            except Exception:
                insts = None
            if insts is None:
                results[i] = False
            else:
                bp_idx.append(i)
                bp_groups.append(insts)

    if bp_groups:
        for i, ok in zip(bp_idx, batch_verify_groups(bp_groups)):
            results[i] = ok
    if eq_entries:
        for i, ok in zip(eq_idx, SnarkBackend.verify_equality_batch(eq_entries)):
            results[i] = ok
    if mem_entries:
        for i, ok in zip(mem_idx, SnarkBackend.verify_membership_batch(mem_entries)):
            results[i] = ok
    for i, r in enumerate(results):
        if r is None:
            results[i] = _verify_single_proof(*items[i])
    return [bool(r) for r in results]


def _bulletproof_instances(proof: Proof):
    """Instance groups for the RLC batch verifier (schemes 1, 3, 6)."""
    from ..models.bulletproofs_backend import BulletproofsBackend
    from ..models.schemes.common import reconstruct_bulletproofs_proof

    payload, commitment = proof.proof, proof.commitment
    if len(commitment) != 32:
        return None
    backend = reconstruct_bulletproofs_proof(payload, commitment)
    if proof.scheme == 1:
        if len(payload) < 20:
            return None
        min_v = int.from_bytes(payload[0:8], "little")
        max_v = int.from_bytes(payload[8:16], "little")
        if min_v > max_v:
            return None
        return BulletproofsBackend.range_instances(backend, min_v, max_v)
    if proof.scheme == 3:
        if len(payload) < 12:
            return None
        threshold = int.from_bytes(payload[0:8], "little")
        return BulletproofsBackend.threshold_instances(backend, threshold)
    if proof.scheme == 6:
        return BulletproofsBackend.consistency_instances(backend)
    return None
