"""Improvement proof (scheme 5): ``new > old`` via STARK.

Port of the JAX package's ``libzkp_tpu/models/schemes/improvement_proof.py``
(the reference's proof/improvement_proof.rs): the payload is ``[old:8
LE][new:8 LE][stark_bytes]``, with the SHA-256 improvement commitment
(commitment.rs:38-50) in the envelope. The provers take a keyword-only
``device=`` (default: the CUDA card; ``"cpu"`` runs the plain PyTorch path)
and run the STARK batch prover, whose coset LDEs and leaf digests run on
that device; the verifier runs on the host's native tier.
"""

from __future__ import annotations

from ...device import resolve
from ...utils.commitment import commit_improvement, validate_improvement_commitment
from ...utils.encoding import u64_le
from ...utils.envelope import SCHEME_IMPROVEMENT, Proof
from ...utils.errors import ProofGenerationFailed, ZkpError
from ...utils.validation import validate_improvement_params
from ..stark_backend import StarkBackend
from ..stark_backend import prove_improvement_batch as _prove_batch
from .common import parse_and_validate_proof

SCHEME_ID = SCHEME_IMPROVEMENT


def prove_improvement(old: int, new: int, *, device=None) -> bytes:
    return prove_improvement_batch([(old, new)], device=device)[0]


def prove_improvement_batch(pairs, *, device=None) -> list:
    """Batched variant over ``(old, new)`` pairs: every proof's trace LDE and
    leaf digests in one device program."""
    device = resolve(device)
    pairs = list(pairs)
    for old, new in pairs:
        validate_improvement_params(old, new)
    out = []
    for (old, new), sp in zip(pairs, _prove_batch(pairs, device=device)):
        if not sp:
            raise ProofGenerationFailed("STARK proof generation failed")
        # old and new prefixed for verification, composite checks included
        # (improvement_proof.rs:28-31)
        payload = u64_le(old) + u64_le(new) + sp
        out.append(Proof.new(SCHEME_ID, payload, commit_improvement(old, new)).to_bytes())
    return out


def verify_improvement(proof: bytes, old: int) -> bool:
    try:
        p = parse_and_validate_proof(proof, SCHEME_ID)
    except ZkpError:
        return False
    if len(p.proof) < 16:
        return False
    if int.from_bytes(p.proof[0:8], "little") != old:
        return False
    new = int.from_bytes(p.proof[8:16], "little")
    try:
        validate_improvement_commitment(p.commitment, old, new)
    except ZkpError:
        return False
    return StarkBackend.verify(p.proof[16:], u64_le(old) + u64_le(new))
