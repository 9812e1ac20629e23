"""Consistency proof (scheme 6): a monotonic non-decreasing sequence.

Port of the JAX package's ``libzkp_tpu/models/schemes/consistency_proof.py``.
The provers take a keyword-only ``device=`` (default: the CUDA card;
``"cpu"`` runs the plain PyTorch path); the verifier runs on the host.
"""

from __future__ import annotations

from typing import List

from ...device import resolve
from ...utils.envelope import SCHEME_CONSISTENCY
from ...utils.errors import InvalidInput
from ...utils.validation import validate_consistency_params
from ..bulletproofs_backend import BulletproofsBackend
from .common import (
    create_proof,
    extract_bulletproofs_components,
    parse_and_validate_proof,
    prove_prepared,
    reconstruct_bulletproofs_proof,
)

SCHEME_ID = SCHEME_CONSISTENCY


def prove_consistency_batch(datas, *, device=None) -> list:
    """Batched variant over sequences: every sequence's step proofs in one
    lockstep device batch (each sequence's commitments one MSM batch)."""
    device = resolve(device)
    datas = [list(d) for d in datas]
    for data in datas:
        validate_consistency_params(data)
    try:
        prepared = [BulletproofsBackend.prepare_consistency(data, device=device) for data in datas]
    except ValueError as e:
        raise InvalidInput(str(e)) from None
    return prove_prepared([(SCHEME_ID, *p) for p in prepared], device=device)


def prove_consistency(data: List[int], *, device=None) -> bytes:
    device = resolve(device)
    validate_consistency_params(data)
    try:
        backend_proof = BulletproofsBackend.prove_consistency(list(data), device=device)
    except ValueError as e:
        raise InvalidInput(str(e)) from None
    proof_bytes, commitment = extract_bulletproofs_components(backend_proof)
    return create_proof(SCHEME_ID, proof_bytes, commitment)


def verify_consistency(proof: bytes) -> bool:
    """Host verifier; never raises."""
    try:
        p = parse_and_validate_proof(proof, SCHEME_ID)
    except Exception:
        return False
    backend_proof = reconstruct_bulletproofs_proof(p.proof, p.commitment)
    return BulletproofsBackend.verify_consistency(backend_proof)
