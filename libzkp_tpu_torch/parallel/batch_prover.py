"""Batch proof generation: a batch's operations bucketed by proof type, each
bucket on its batch prover on one device.

Port of the JAX package's ``libzkp_tpu/parallel/batch_prover.py`` (which
replaces the reference's rayon ``par_iter`` over batch operations,
``advanced/batch.rs:123-131``). The buckets run in the reference's order,
which is also the order of their random draws, so under one ``os.urandom``
stream the proofs are byte-identical to the JAX package's:

1. the MiMC commitments of the equality and membership values, in one
   :func:`.ops.mimc.mimc_hash_batch` on the device when there are at least
   :data:`MIN_PREHASH_VALUES` distinct values (no draws);
2. the equality bucket, one ``prove_equality_batch`` (r, s a proof);
3. the membership bucket, one ``prove_membership_batch`` (likewise);
4. the Bulletproofs pool: every range, threshold and consistency op's
   ``prepare_*`` in op order (its blindings; consistency's commitments one
   seam MSM), then every single-proof instance in one lockstep
   ``prove_single_batch`` (the prover draws);
5. the improvements, one ``prove_improvement_batch`` (no draws).

Where the JAX package differs: it proves a bucket of one op, and every
improvement when there are fewer than 64, on a host thread pool; here every
bucket of one op or more goes to its batch prover, so there is no thread
pool (the native tier's OpenMP team is the port's only host parallelism).
It primes a MiMC memo with the pre-hash; here the commitments go to the two
Groth16 batch provers by argument. Any failure fails the whole batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..device import resolve
from ..models.bulletproofs_backend import BulletproofsBackend
from ..models.schemes.common import prove_prepared
from ..models.schemes.equality_proof import prove_equality_batch
from ..models.schemes.improvement_proof import prove_improvement_batch
from ..models.schemes.set_membership import prove_membership_batch
from ..ops.mimc import fr_to_commitment, mimc_hash_batch
from ..utils import tracing
from ..utils.composition import BatchOperation
from ..utils.envelope import SCHEME_CONSISTENCY, SCHEME_RANGE, SCHEME_THRESHOLD
from ..utils.errors import BackendError, InvalidInput

# The reference's _MIN_DEVICE_BATCH: fewer distinct values than this are
# hashed on the host, one commit_value_snark each, by the provers themselves.
MIN_PREHASH_VALUES = 64


def snark_commitments(ops: Sequence[BatchOperation], *, device) -> Optional[dict]:
    """value -> 32-byte MiMC commitment for every distinct equality and
    membership value, hashed in one device batch; None below
    :data:`MIN_PREHASH_VALUES` distinct values."""
    values = sorted({op.args[0] for op in ops if op.kind in ("equality", "membership")})
    if len(values) < MIN_PREHASH_VALUES:
        return None
    return {v: fr_to_commitment(h) for v, h in zip(values, mimc_hash_batch(values, device=device))}


def _prepare(op: BatchOperation, *, device) -> tuple:
    """``(scheme_id, instances, finish)`` of a range, threshold or
    consistency op at 64 bits, with the exception classes of the per-scheme
    batch provers."""
    try:
        if op.kind == "range":
            return (SCHEME_RANGE, *BulletproofsBackend.prepare_range_bits(*op.args, 64))
        if op.kind == "threshold":
            values, threshold = op.args
            return (SCHEME_THRESHOLD,
                    *BulletproofsBackend.prepare_threshold_bits(list(values), threshold, 64))
        (data,) = op.args
        return (SCHEME_CONSISTENCY,
                *BulletproofsBackend.prepare_consistency(list(data), device=device))
    except ValueError as e:
        if op.kind == "range":
            raise BackendError(str(e)) from None
        raise InvalidInput(str(e)) from None


def process_operations(ops: Sequence[BatchOperation], *, device=None) -> List[bytes]:
    """Prove every operation on ``device`` (default: the CUDA card); the
    envelopes in op order. Raises on the first failure."""
    device = resolve(device)
    items = list(ops)
    for op in items:
        if op.kind not in BatchOperation.KINDS:
            raise InvalidInput(f"unknown batch operation: {op.kind}")
    results: List[bytes] = [b""] * len(items)

    def bucket(*kinds) -> List[int]:
        return [i for i, op in enumerate(items) if op.kind in kinds]

    def put(idx: List[int], proofs: List[bytes]) -> None:
        for i, proof in zip(idx, proofs):
            results[i] = proof

    with tracing.span("prehash"):
        commitments = snark_commitments(items, device=device)
    for kind, name, prove in (("equality", "g16.equality", prove_equality_batch),
                              ("membership", "g16.membership", prove_membership_batch)):
        idx = bucket(kind)
        if idx:
            given = None if commitments is None else [commitments[items[i].args[0]] for i in idx]
            with tracing.span(name):
                put(idx, prove([items[i].args for i in idx], device=device, commitments=given))
    idx = bucket("range", "threshold", "consistency")
    if idx:
        with tracing.span("bp.prepare"):
            prepared = [_prepare(items[i], device=device) for i in idx]
        with tracing.span("bp.prove"):
            put(idx, prove_prepared(prepared, device=device))
    idx = bucket("improvement")
    if idx:
        with tracing.span("stark"):
            put(idx, prove_improvement_batch([items[i].args for i in idx], device=device))
    return results
