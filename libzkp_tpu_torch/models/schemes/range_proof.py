"""Range proof (scheme 1): min <= value <= max via two-sided Bulletproofs.

Port of the JAX package's ``libzkp_tpu/models/schemes/range_proof.py``. The
provers take a keyword-only ``device=`` (default: the CUDA card; ``"cpu"``
runs the plain PyTorch path); the verifier runs on the host.
"""

from __future__ import annotations

from ...device import resolve
from ...utils.envelope import SCHEME_RANGE
from ...utils.errors import BackendError
from ...utils.validation import validate_range_params
from ..bulletproofs_backend import BulletproofsBackend
from .common import (
    create_proof,
    extract_bulletproofs_components,
    parse_and_validate_proof,
    prove_prepared,
    reconstruct_bulletproofs_proof,
    validate_standard_commitment,
)

SCHEME_ID = SCHEME_RANGE


def prove_range(value: int, min_v: int, max_v: int, *, device=None) -> bytes:
    return prove_range_with_bits(value, min_v, max_v, 64, device=device)


def prove_range_with_bits(
    value: int, min_v: int, max_v: int, n_bits: int, *, device=None
) -> bytes:
    """Range proof with a configurable bit width (8 for values in [0, 255]):
    64 bits on the device prover, 1 to 32 on the lockstep host prover with
    its MSMs on ``device``."""
    device = resolve(device)
    validate_range_params(value, min_v, max_v)
    try:
        backend_proof = BulletproofsBackend.prove_range_with_bounds_bits(
            value, min_v, max_v, n_bits, device=device
        )
    except ValueError as e:
        raise BackendError(str(e)) from None
    proof_bytes, commitment = extract_bulletproofs_components(backend_proof)
    return create_proof(SCHEME_ID, proof_bytes, commitment)


def prove_range_batch(triples, *, device=None) -> list:
    """Batched variant over ``(value, min_v, max_v)`` triples at 64 bits: the
    min/max single proofs of every triple run as one lockstep device batch."""
    device = resolve(device)
    triples = list(triples)
    for value, min_v, max_v in triples:
        validate_range_params(value, min_v, max_v)
    try:
        prepared = [BulletproofsBackend.prepare_range_bits(value, min_v, max_v, 64)
                    for value, min_v, max_v in triples]
    except ValueError as e:
        raise BackendError(str(e)) from None
    return prove_prepared([(SCHEME_ID, *p) for p in prepared], device=device)


def verify_range(proof: bytes, min_v: int, max_v: int) -> bool:
    """Host verifier; never raises."""
    if min_v > max_v:
        return False
    try:
        p = parse_and_validate_proof(proof, SCHEME_ID)
        validate_standard_commitment(p.commitment)
    except Exception:
        return False
    backend_proof = reconstruct_bulletproofs_proof(p.proof, p.commitment)
    return BulletproofsBackend.verify_range_with_bounds(backend_proof, min_v, max_v)
