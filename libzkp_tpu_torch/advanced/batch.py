"""Batch registry + processing.

Port of the JAX package's ``libzkp_tpu/advanced/batch.py`` (the Rust
reference's ``advanced/batch.rs``): a process-global registry of
``ProofBatch`` keyed by cryptographically random non-zero u64 ids; every
mutation re-persists when a store is configured; ``process_batch`` consumes
the batch (removes it and its file) and generates all proofs through
:func:`..parallel.batch_prover.process_operations` on one device (default:
the CUDA card; ``device="cpu"`` runs the plain PyTorch path).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List

from ..device import resolve
from ..parallel.batch_prover import process_operations
from ..utils import tracing, validation
from ..utils.composition import BatchOperation, ProofBatch
from ..utils.errors import InvalidInput
from . import batch_store

_registry_lock = threading.Lock()
_registry: Dict[int, ProofBatch] = {}


def _allocate_batch_id() -> int:
    while True:
        bid = int.from_bytes(os.urandom(8), "little")
        if bid != 0 and bid not in _registry:
            return bid


def create_proof_batch() -> int:
    """New batch; returns its cryptographically random non-zero u64 id."""
    with _registry_lock:
        bid = _allocate_batch_id()
        _registry[bid] = ProofBatch()
        batch_store.persist_batch_if_configured(bid, _registry[bid])
    return bid


def _with_batch_mut(batch_id: int, fn) -> None:
    with _registry_lock:
        batch = _registry.get(batch_id)
        if batch is None:
            raise InvalidInput(f"Invalid batch ID: {batch_id}")
        fn(batch)
        batch_store.persist_batch_if_configured(batch_id, batch)


def batch_add_range_proof(batch_id: int, value: int, min_v: int, max_v: int) -> None:
    validation.validate_range_params(value, min_v, max_v)
    _with_batch_mut(batch_id, lambda b: b.add_range_proof(value, min_v, max_v))


def batch_add_equality_proof(batch_id: int, val1: int, val2: int) -> None:
    validation.validate_equality_params(val1, val2)
    _with_batch_mut(batch_id, lambda b: b.add_equality_proof(val1, val2))


def batch_add_threshold_proof(batch_id: int, values: List[int], threshold: int) -> None:
    validation.validate_threshold_params(values, threshold)
    _with_batch_mut(batch_id, lambda b: b.add_threshold_proof(values, threshold))


def batch_add_membership_proof(batch_id: int, value: int, the_set: List[int]) -> None:
    validation.validate_membership_params(value, the_set)
    _with_batch_mut(batch_id, lambda b: b.add_membership_proof(value, the_set))


def batch_add_improvement_proof(batch_id: int, old: int, new: int) -> None:
    validation.validate_improvement_params(old, new)
    _with_batch_mut(batch_id, lambda b: b.add_improvement_proof(old, new))


def batch_add_consistency_proof(batch_id: int, data: List[int]) -> None:
    validation.validate_consistency_params(data)
    _with_batch_mut(batch_id, lambda b: b.add_consistency_proof(data))


def process_batch(batch_id: int, *, device=None) -> List[bytes]:
    """Generate all proofs for the batch on ``device``; the batch is
    CONSUMED (batch.rs:110-140), and its file deleted, before the proving.

    Failure of any single operation fails the whole batch. Its spans
    (:mod:`..utils.tracing`) carry ``batch_id``.
    """
    with tracing.span("batch", batch=batch_id):
        device = resolve(device)
        with _registry_lock:
            batch = _registry.pop(batch_id, None)
        if batch is None:
            raise InvalidInput(f"Invalid batch ID: {batch_id}")
        batch_store.delete_batch_file_if_configured(batch_id)
        return process_operations(batch.operations, device=device)


def get_batch_status(batch_id: int) -> Dict[str, int]:
    with _registry_lock:
        batch = _registry.get(batch_id)
        if batch is None:
            raise InvalidInput(f"Invalid batch ID: {batch_id}")
        ops = list(batch.operations)
    status = {"total_operations": len(ops)}
    for kind in BatchOperation.KINDS:
        status[f"{kind}_proofs"] = sum(1 for op in ops if op.kind == kind)
    return status


def clear_batch(batch_id: int) -> None:
    with _registry_lock:
        _registry.pop(batch_id, None)
    batch_store.delete_batch_file_if_configured(batch_id)


def open_batch_from_store(batch_id: int) -> None:
    """Load a batch from disk into this process registry (batch.rs:193-211)."""
    directory = batch_store._store_dir_required()
    with _registry_lock:
        if batch_id in _registry:
            raise InvalidInput(f"batch {batch_id} is already open in this process")
        batch = batch_store.read_batch_file(directory, batch_id)
        _registry[batch_id] = batch


def refresh_batch_from_store(batch_id: int) -> None:
    """Replace the in-memory batch with the on-disk contents (batch.rs:215-233)."""
    directory = batch_store._store_dir_required()
    with _registry_lock:
        if batch_id not in _registry:
            raise InvalidInput(f"batch {batch_id} is not loaded in this process")
        _registry[batch_id] = batch_store.read_batch_file(directory, batch_id)


def export_batch_to_file(batch_id: int, dest: str) -> None:
    with _registry_lock:
        batch = _registry.get(batch_id)
        if batch is None:
            raise InvalidInput(f"Invalid batch ID: {batch_id}")
        batch_store.export_proof_batch_to_path(batch, dest)


def import_batch_from_file(src: str) -> int:
    pb = batch_store.import_proof_batch_from_path(src)
    with _registry_lock:
        bid = _allocate_batch_id()
        _registry[bid] = pb
        batch_store.persist_batch_if_configured(bid, pb)
    return bid


def _reset_for_tests() -> None:
    with _registry_lock:
        _registry.clear()
