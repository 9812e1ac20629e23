"""Equality proof (scheme 2): Groth16 + MiMC commitment binding.

Port of the JAX package's ``libzkp_tpu/models/schemes/equality_proof.py``.
The provers take a keyword-only ``device=`` (default: the CUDA card;
``"cpu"`` runs the plain PyTorch path) and run the batched Groth16 prover,
whose query MSMs run on that device; the verifiers run on the host.
"""

from __future__ import annotations

from ...device import resolve
from ...utils.commitment import commit_value_snark
from ...utils.envelope import SCHEME_EQUALITY, Proof
from ...utils.errors import ProofGenerationFailed
from ...utils.validation import validate_equality_params
from ..snark_backend import SnarkBackend
from .common import parse_and_validate_proof, validate_standard_commitment

SCHEME_ID = SCHEME_EQUALITY


def prove_equality(val1: int, val2: int, *, device=None) -> bytes:
    return prove_equality_batch([(val1, val2)], device=device)[0]


def prove_equality_batch(pairs, *, device=None, commitments=None) -> list:
    """Batched variant over ``(val1, val2)`` pairs: all proofs of the fixed
    equality circuit share each proving-key table walk on the device.

    ``commitments`` (one 32-byte MiMC commitment of ``val1`` a pair, from a
    caller that hashed them in one device batch) replaces the per-pair
    :func:`commit_value_snark`; a commitment that is not MiMC5(val1) gets
    no proof, and the batch raises."""
    device = resolve(device)
    pairs = list(pairs)
    for v1, v2 in pairs:
        validate_equality_params(v1, v2)
    if commitments is None:
        commitments = [commit_value_snark(v1) for v1, _ in pairs]
    elif len(commitments) != len(pairs):
        raise ValueError(f"{len(commitments)} commitments for {len(pairs)} pairs")
    snarks = SnarkBackend.prove_equality_zk_many(
        [(v1, v2, c) for (v1, v2), c in zip(pairs, commitments)], device=device
    )
    out = []
    for sp, c in zip(snarks, commitments):
        if not sp:
            raise ProofGenerationFailed("SNARK proof generation failed")
        out.append(Proof.new(SCHEME_ID, sp, c).to_bytes())
    return out


def _verify_equality_inner(proof: bytes, expected_commitment: bytes) -> bool:
    try:
        p = parse_and_validate_proof(proof, SCHEME_ID)
        validate_standard_commitment(expected_commitment)
    except Exception:
        return False
    if p.commitment != bytes(expected_commitment):
        return False
    return SnarkBackend.verify_equality_zk(p.proof, expected_commitment)


def verify_equality(proof: bytes, val1: int, val2: int) -> bool:
    if val1 != val2:
        return False
    return _verify_equality_inner(proof, commit_value_snark(val1))


def verify_equality_with_commitment(proof: bytes, expected_commitment: bytes) -> bool:
    return _verify_equality_inner(proof, bytes(expected_commitment))
