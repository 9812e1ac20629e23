"""Public Python API — the reference's 49-name surface.

Port of the JAX package's ``libzkp_tpu/api.py``, function for function what
the Rust reference registers on its Python module (``python_api.rs:110-163``):
same names, same positional signatures, same exception mapping
(``ValueError`` for invalid input, ``TypeError`` for format/config errors,
``RuntimeError`` for the rest — error_handling.rs:39-50). Byte parameters
accept any bytes-like object and return ``bytes``.

Every name that proves also takes a keyword-only ``device=`` (default: the
CUDA card, and an error without one; ``"cpu"`` runs the plain PyTorch path).
Verifiers run on the host. The port's batch entry points
(``prove_range_batch`` and the like) are not part of this surface.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import advanced as _advanced
from .models.schemes import consistency_proof as _consistency
from .models.schemes import equality_proof as _equality
from .models.schemes import improvement_proof as _improvement
from .models.schemes import range_proof as _range
from .models.schemes import set_membership as _membership
from .models.schemes import threshold_proof as _threshold
from .utils import commitment as _commitment

__all__ = [
    # single-proof API
    "prove_range", "verify_range",
    "prove_equality", "verify_equality", "verify_equality_with_commitment",
    "snark_commit_value",
    "prove_threshold", "verify_threshold",
    "prove_membership", "verify_membership",
    "prove_improvement", "verify_improvement",
    "prove_consistency", "verify_consistency",
    # composite
    "create_composite_proof", "verify_composite_proof",
    "verify_composite_proof_integrity_only",
    "create_proof_with_metadata", "extract_proof_metadata",
    # cache / metrics / benchmarks / misc
    "clear_cache", "get_cache_stats", "get_performance_metrics",
    "benchmark_proof_generation_numeric", "benchmark_proof_generation",
    "prove_range_cached", "prove_equality_advanced", "verify_proofs_parallel",
    "prove_threshold_optimized", "validate_proof_chain", "get_proof_info",
    "set_snark_key_dir", "is_snark_setup_initialized",
    # batch
    "create_proof_batch",
    "batch_add_range_proof", "batch_add_equality_proof",
    "batch_add_threshold_proof", "batch_add_membership_proof",
    "batch_add_improvement_proof", "batch_add_consistency_proof",
    "process_batch", "get_batch_status", "clear_batch",
    # batch store
    "set_batch_store_dir", "get_batch_store_dir", "list_batch_ids_in_store",
    "open_batch_from_store", "refresh_batch_from_store",
    "export_batch_to_file", "import_batch_from_file",
]


def _b(data) -> bytes:
    """Coerce bytes-like / list[int] (PyO3 Vec<u8> semantics)."""
    if isinstance(data, bytes):
        return data
    return bytes(data)


# ---------------------------------------------------------------------------
# Single-proof API (python_api.rs:25-45)
# ---------------------------------------------------------------------------


def prove_range(value: int, min: int, max: int, *, device=None) -> bytes:  # noqa: A002
    """Prove ``min <= value <= max`` without revealing ``value`` (scheme 1)."""
    return _range.prove_range(value, min, max, device=device)


def verify_range(proof, min: int, max: int) -> bool:  # noqa: A002
    return _range.verify_range(_b(proof), min, max)


def prove_equality(val1: int, val2: int, *, device=None) -> bytes:
    """Prove two committed values are equal (Groth16 + MiMC, scheme 2)."""
    return _equality.prove_equality(val1, val2, device=device)


def verify_equality(proof, val1: int, val2: int) -> bool:
    return _equality.verify_equality(_b(proof), val1, val2)


def verify_equality_with_commitment(proof, expected_commitment) -> bool:
    return _equality.verify_equality_with_commitment(_b(proof), _b(expected_commitment))


def snark_commit_value(value: int) -> bytes:
    """MiMC-5 (BN254 Fr) 32-byte commitment (python_api.rs:33-34)."""
    return _commitment.commit_value_snark(value)


def prove_threshold(values: List[int], threshold: int, *, device=None) -> bytes:
    """Prove ``sum(values) >= threshold`` (scheme 3)."""
    return _threshold.prove_threshold(list(values), threshold, device=device)


def verify_threshold(proof, threshold: int) -> bool:
    return _threshold.verify_threshold(_b(proof), threshold)


def prove_membership(value: int, set: List[int], *, device=None) -> bytes:  # noqa: A002
    """Prove ``value in set`` without revealing which element (scheme 4)."""
    return _membership.prove_membership(value, list(set), device=device)


def verify_membership(proof, set: List[int]) -> bool:  # noqa: A002
    return _membership.verify_membership(_b(proof), list(set))


def prove_improvement(old: int, new: int, *, device=None) -> bytes:
    """Prove ``new > old`` via STARK (scheme 5)."""
    return _improvement.prove_improvement(old, new, device=device)


def verify_improvement(proof, old: int) -> bool:
    return _improvement.verify_improvement(_b(proof), old)


def prove_consistency(data: List[int], *, device=None) -> bytes:
    """Prove a sequence is monotonic non-decreasing (scheme 6)."""
    return _consistency.prove_consistency(list(data), device=device)


def verify_consistency(proof) -> bool:
    return _consistency.verify_consistency(_b(proof))


# ---------------------------------------------------------------------------
# Composite proofs (python_api.rs:47-51)
# ---------------------------------------------------------------------------


def create_composite_proof(proof_list: List) -> bytes:
    return _advanced.create_composite_proof([_b(p) for p in proof_list])


def verify_composite_proof(composite_bytes) -> bool:
    return _advanced.verify_composite_proof(_b(composite_bytes))


def verify_composite_proof_integrity_only(composite_bytes) -> bool:
    return _advanced.verify_composite_proof_integrity_only(_b(composite_bytes))


def create_proof_with_metadata(proof_data, metadata: Dict[str, bytes]) -> bytes:
    return _advanced.create_proof_with_metadata(
        _b(proof_data), {k: _b(v) for k, v in metadata.items()}
    )


def extract_proof_metadata(composite_bytes) -> Dict[str, bytes]:
    return _advanced.extract_proof_metadata(_b(composite_bytes))


# ---------------------------------------------------------------------------
# Cache / metrics / benchmarks / misc (python_api.rs:53-66)
# ---------------------------------------------------------------------------


def clear_cache() -> None:
    _advanced.clear_cache()


def get_cache_stats() -> Dict[str, int]:
    return _advanced.get_cache_stats()


def get_performance_metrics() -> Dict[str, float]:
    return _advanced.get_performance_metrics()


def benchmark_proof_generation_numeric(proof_type: str, iterations: int, *,
                                       device=None) -> Dict[str, float]:
    return _advanced.benchmark_proof_generation_numeric(proof_type, iterations, device=device)


def benchmark_proof_generation(proof_type: str, iterations: int, *, device=None) -> Dict[str, str]:
    return _advanced.benchmark_proof_generation(proof_type, iterations, device=device)


def prove_range_cached(value: int, min: int, max: int, *, device=None) -> bytes:  # noqa: A002
    return _advanced.prove_range_cached(value, min, max, device=device)


def prove_equality_advanced(val1: int, val2: int, *, device=None) -> bytes:
    return _advanced.prove_equality_advanced(val1, val2, device=device)


def verify_proofs_parallel(proofs: List[Tuple]) -> List[bool]:
    return _advanced.verify_proofs_parallel([(_b(p), str(t)) for p, t in proofs])


def prove_threshold_optimized(values: List[int], threshold: int, *, device=None) -> bytes:
    return _advanced.prove_threshold_optimized(list(values), threshold, device=device)


def validate_proof_chain(proof_chain: List) -> bool:
    return _advanced.validate_proof_chain([_b(p) for p in proof_chain])


def get_proof_info(proof_bytes) -> Dict[str, int]:
    return _advanced.get_proof_info(_b(proof_bytes))


def set_snark_key_dir(path: str) -> bool:
    return _advanced.set_snark_key_dir(path)


def is_snark_setup_initialized() -> bool:
    return _advanced.is_snark_setup_initialized()


# ---------------------------------------------------------------------------
# Batch API (python_api.rs:67-77)
# ---------------------------------------------------------------------------


def create_proof_batch() -> int:
    return _advanced.create_proof_batch()


def batch_add_range_proof(batch_id: int, value: int, min: int, max: int) -> None:  # noqa: A002
    _advanced.batch_add_range_proof(batch_id, value, min, max)


def batch_add_equality_proof(batch_id: int, val1: int, val2: int) -> None:
    _advanced.batch_add_equality_proof(batch_id, val1, val2)


def batch_add_threshold_proof(batch_id: int, values: List[int], threshold: int) -> None:
    _advanced.batch_add_threshold_proof(batch_id, list(values), threshold)


def batch_add_membership_proof(batch_id: int, value: int, set: List[int]) -> None:  # noqa: A002
    _advanced.batch_add_membership_proof(batch_id, value, list(set))


def batch_add_improvement_proof(batch_id: int, old: int, new: int) -> None:
    _advanced.batch_add_improvement_proof(batch_id, old, new)


def batch_add_consistency_proof(batch_id: int, data: List[int]) -> None:
    _advanced.batch_add_consistency_proof(batch_id, list(data))


def process_batch(batch_id: int, *, device=None) -> List[bytes]:
    return _advanced.process_batch(batch_id, device=device)


def get_batch_status(batch_id: int) -> Dict[str, int]:
    return _advanced.get_batch_status(batch_id)


def clear_batch(batch_id: int) -> None:
    _advanced.clear_batch(batch_id)


# ---------------------------------------------------------------------------
# Batch store (python_api.rs:80-107, feature "batch-store")
# ---------------------------------------------------------------------------


def set_batch_store_dir(path: str) -> None:
    _advanced.set_batch_store_dir(path)


def get_batch_store_dir() -> Optional[str]:
    d = _advanced.get_batch_store_dir()
    return str(d) if d is not None else None


def list_batch_ids_in_store() -> List[int]:
    return _advanced.list_batch_ids_in_store()


def open_batch_from_store(batch_id: int) -> None:
    _advanced.open_batch_from_store(batch_id)


def refresh_batch_from_store(batch_id: int) -> None:
    _advanced.refresh_batch_from_store(batch_id)


def export_batch_to_file(batch_id: int, dest: str) -> None:
    _advanced.export_batch_to_file(batch_id, dest)


def import_batch_from_file(src: str) -> int:
    return _advanced.import_batch_from_file(src)
