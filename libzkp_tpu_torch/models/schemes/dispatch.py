"""Universal scheme-dispatch verifier.

Port of the JAX package's ``libzkp_tpu/models/schemes/dispatch.py`` (the Rust
reference's ``verify_proof_cryptographic``, ``utils/proof_helpers.rs:156-247``):
verify a parsed :class:`Proof` envelope by its scheme id, reading the public
parameters (min/max/threshold/old/new/set) out of the payload itself, on the
port's host verifiers.
"""

from __future__ import annotations

from ...utils.commitment import validate_improvement_commitment
from ...utils.encoding import u64_le
from ...utils.envelope import PROOF_VERSION, Proof
from ...utils.errors import ZkpError
from ..bulletproofs_backend import BulletproofsBackend
from ..snark_backend import MAX_SET_SIZE, SnarkBackend
from ..stark_backend import StarkBackend
from .common import deserialize_embedded_set_prefix, reconstruct_bulletproofs_proof


def verify_proof_cryptographic(proof: Proof) -> bool:
    """The envelope's verdict; never raises (a verifier's contract: anything
    malformed is ``False``)."""
    if proof.version != PROOF_VERSION:
        return False
    scheme = proof.scheme
    payload = proof.proof
    commitment = proof.commitment
    try:
        if scheme == 1:
            # [min:8][max:8][n_bits:4][...] — minimum 20 bytes
            if len(payload) < 20 or len(commitment) != 32:
                return False
            min_v = int.from_bytes(payload[0:8], "little")
            max_v = int.from_bytes(payload[8:16], "little")
            if min_v > max_v:
                return False
            backend = reconstruct_bulletproofs_proof(payload, commitment)
            return BulletproofsBackend.verify_range_with_bounds(backend, min_v, max_v)
        if scheme == 2:
            if len(commitment) != 32:
                return False
            return SnarkBackend.verify(payload, commitment)
        if scheme == 3:
            # [threshold:8][n_bits:4][...] — minimum 12 bytes
            if len(payload) < 12 or len(commitment) != 32:
                return False
            threshold = int.from_bytes(payload[0:8], "little")
            backend = reconstruct_bulletproofs_proof(payload, commitment)
            return BulletproofsBackend.verify_threshold(backend, threshold)
        if scheme == 4:
            if len(commitment) != 32:
                return False
            parsed = deserialize_embedded_set_prefix(payload, MAX_SET_SIZE)
            if parsed is None:
                return False
            the_set, snark_bytes = parsed
            if not snark_bytes:
                return False
            return SnarkBackend.verify_membership_zk(snark_bytes, the_set, commitment)
        if scheme == 5:
            if len(commitment) != 32 or len(payload) < 16:
                return False
            old = int.from_bytes(payload[0:8], "little")
            new = int.from_bytes(payload[8:16], "little")
            try:
                validate_improvement_commitment(commitment, old, new)
            except ZkpError:
                return False
            return StarkBackend.verify(payload[16:], u64_le(old) + u64_le(new))
        if scheme == 6:
            backend = reconstruct_bulletproofs_proof(payload, commitment)
            return BulletproofsBackend.verify_consistency(backend)
        return False
    except Exception:  # a verifier's "never raise"; it wraps no prover and no card call
        return False
