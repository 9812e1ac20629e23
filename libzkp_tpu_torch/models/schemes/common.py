"""Shared envelope parse/build helpers for the proof layer.

Copy of the JAX package's ``libzkp_tpu/models/schemes/common.py``, and
:func:`prove_prepared`, the Bulletproofs batch variants' shared tail.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ...utils import tracing
from ...utils.encoding import u32_le
from ...utils.envelope import PROOF_VERSION, Proof
from ...utils.errors import InvalidProofFormat
from ...utils.limits import (
    MAX_BULLETPROOFS_BACKEND_PROOF_BYTES,
    MAX_PROOF_TOTAL_BYTES,
)
from ..bulletproofs import prove_single_batch


def parse_and_validate_proof(proof_bytes: bytes, expected_scheme: int) -> Proof:
    """Common parsing/validation of the versioned envelope."""
    if len(proof_bytes) > MAX_PROOF_TOTAL_BYTES:
        raise InvalidProofFormat(f"proof too large: max {MAX_PROOF_TOTAL_BYTES} bytes")
    proof = Proof.from_bytes(proof_bytes)
    if proof.version != PROOF_VERSION:
        raise InvalidProofFormat(
            f"unsupported proof version: expected {PROOF_VERSION}, got {proof.version}"
        )
    if proof.scheme != expected_scheme:
        raise InvalidProofFormat(
            f"wrong proof scheme: expected {expected_scheme}, got {proof.scheme}"
        )
    return proof


def extract_bulletproofs_components(backend_proof: bytes) -> Tuple[bytes, bytes]:
    """Unwrap ``[u32 len][body][u32=32][commit32]``."""
    if len(backend_proof) > MAX_BULLETPROOFS_BACKEND_PROOF_BYTES:
        raise InvalidProofFormat(
            f"backend proof too large: max {MAX_BULLETPROOFS_BACKEND_PROOF_BYTES} bytes"
        )
    if len(backend_proof) < 4 + 4 + 32:
        raise InvalidProofFormat("bulletproofs backend payload too short")
    plen = int.from_bytes(backend_proof[0:4], "little")
    proof_end = 4 + plen
    if len(backend_proof) < proof_end + 4 + 32:
        raise InvalidProofFormat("truncated bulletproofs backend payload")
    clen = int.from_bytes(backend_proof[proof_end : proof_end + 4], "little")
    if clen != 32:
        raise InvalidProofFormat("invalid commitment length (expected 32)")
    if len(backend_proof) != proof_end + 4 + 32:
        raise InvalidProofFormat("trailing bytes in bulletproofs backend payload")
    return backend_proof[4:proof_end], backend_proof[proof_end + 4 :]


def reconstruct_bulletproofs_proof(proof_bytes: bytes, commitment: bytes) -> bytes:
    """Inverse of :func:`extract_bulletproofs_components`."""
    return u32_le(len(proof_bytes)) + bytes(proof_bytes) + u32_le(32) + bytes(commitment)


def create_proof(scheme_id: int, proof_bytes: bytes, commitment: bytes) -> bytes:
    return Proof.new(scheme_id, proof_bytes, commitment).to_bytes()


def deserialize_embedded_set_prefix(data: bytes,
                                    max_set_len: int) -> Optional[Tuple[List[int], bytes]]:
    """Parse a ``[u32 set_len][u64 x set_len]`` prefix: (the set, the rest),
    or None for an empty or oversized set or a payload with nothing after
    the set."""
    if len(data) < 4:
        return None
    set_size = int.from_bytes(data[0:4], "little")
    if set_size == 0 or set_size > max_set_len:
        return None
    needed = 4 + set_size * 8
    if len(data) <= needed:
        return None
    out = [int.from_bytes(data[4 + i * 8 : 12 + i * 8], "little") for i in range(set_size)]
    return out, data[needed:]


def validate_standard_commitment(commitment: bytes) -> None:
    if len(commitment) != 32:
        raise InvalidProofFormat(
            f"invalid commitment size: expected 32 bytes, got {len(commitment)}"
        )


def prove_prepared(prepared: List, *, device) -> List[bytes]:
    """Envelopes of the backend's prepared proofs, ``(scheme_id, instances,
    finish)`` entries (a ``prepare_*``'s pair under its scheme id, any mix of
    schemes): every proof's single-proof instances as one lockstep
    :func:`prove_single_batch` on ``device``."""
    instances = [inst for _, insts, _ in prepared for inst in insts]
    results = prove_single_batch(instances, device=device)
    out = []
    pos = 0
    with tracing.span("bp.envelope"):
        for scheme_id, insts, finish in prepared:
            backend_proof = finish(results[pos : pos + len(insts)])
            pos += len(insts)
            out.append(create_proof(scheme_id, *extract_bulletproofs_components(backend_proof)))
    return out
