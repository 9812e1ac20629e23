"""Threshold proof (scheme 3): sum(values) >= threshold.

Port of the JAX package's ``libzkp_tpu/models/schemes/threshold_proof.py``.
The provers take a keyword-only ``device=`` (default: the CUDA card;
``"cpu"`` runs the plain PyTorch path); the verifier runs on the host.
"""

from __future__ import annotations

from typing import List

from ...device import resolve
from ...utils.envelope import SCHEME_THRESHOLD
from ...utils.errors import InvalidInput
from ...utils.validation import validate_threshold_params
from ..bulletproofs_backend import BulletproofsBackend
from .common import (
    create_proof,
    extract_bulletproofs_components,
    parse_and_validate_proof,
    prove_prepared,
    reconstruct_bulletproofs_proof,
    validate_standard_commitment,
)

SCHEME_ID = SCHEME_THRESHOLD


def prove_threshold_batch(pairs, *, device=None) -> list:
    """Batched variant over ``(values, threshold)`` pairs at 64 bits: every
    pair's single proof in one lockstep device batch."""
    device = resolve(device)
    pairs = [(list(v), t) for v, t in pairs]
    for values, threshold in pairs:
        validate_threshold_params(values, threshold)
    try:
        prepared = [BulletproofsBackend.prepare_threshold_bits(values, threshold, 64)
                    for values, threshold in pairs]
    except ValueError as e:
        raise InvalidInput(str(e)) from None
    return prove_prepared([(SCHEME_ID, *p) for p in prepared], device=device)


def prove_threshold(values: List[int], threshold: int, *, device=None) -> bytes:
    return prove_threshold_with_bits(values, threshold, 64, device=device)


def prove_threshold_with_bits(
    values: List[int], threshold: int, n_bits: int, *, device=None
) -> bytes:
    """Threshold proof; 8 bits when sum - threshold fits in [0, 255]."""
    device = resolve(device)
    validate_threshold_params(values, threshold)
    try:
        backend_proof = BulletproofsBackend.prove_threshold_bits(
            list(values), threshold, n_bits, device=device
        )
    except ValueError as e:
        raise InvalidInput(str(e)) from None
    proof_bytes, commitment = extract_bulletproofs_components(backend_proof)
    return create_proof(SCHEME_ID, proof_bytes, commitment)


def verify_threshold(proof: bytes, threshold: int) -> bool:
    """Host verifier; never raises."""
    try:
        p = parse_and_validate_proof(proof, SCHEME_ID)
        validate_standard_commitment(p.commitment)
    except Exception:
        return False
    backend_proof = reconstruct_bulletproofs_proof(p.proof, p.commitment)
    return BulletproofsBackend.verify_threshold(backend_proof, threshold)
