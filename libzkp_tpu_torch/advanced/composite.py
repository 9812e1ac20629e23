"""Composite-proof API.

Copy of the JAX package's ``libzkp_tpu/advanced/composite.py`` (the Rust
reference's ``advanced/composite.rs``): the ``COMP`` bytes equal the JAX
package's for the same proofs and metadata.
"""

from __future__ import annotations

from typing import Dict, List

from ..utils.composition import CompositeProof
from ..utils.envelope import Proof
from ..utils.errors import InvalidInput


def create_composite_proof(proof_list: List[bytes]) -> bytes:
    if not proof_list:
        raise InvalidInput("proof list cannot be empty")
    proofs = [Proof.from_bytes(b) for b in proof_list]
    return CompositeProof(proofs).to_bytes()


def verify_composite_proof(composite_bytes: bytes) -> bool:
    """Structural hash (proofs + metadata) and each inner ZKP."""
    return CompositeProof.from_bytes(composite_bytes).verify_full()


def verify_composite_proof_integrity_only(composite_bytes: bytes) -> bool:
    """Only the composite encoding hash; no cryptographic verification."""
    return CompositeProof.from_bytes(composite_bytes).verify_integrity()


def create_proof_with_metadata(proof_data: bytes, metadata: Dict[str, bytes]) -> bytes:
    proof = Proof.from_bytes(proof_data)
    composite = CompositeProof([proof])
    for key, value in metadata.items():
        composite.add_metadata(key, value)
    return composite.to_bytes()


def extract_proof_metadata(composite_bytes: bytes) -> Dict[str, bytes]:
    return dict(CompositeProof.from_bytes(composite_bytes).metadata)
