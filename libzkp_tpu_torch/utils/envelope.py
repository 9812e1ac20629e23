"""Versioned proof byte envelope shared by all six schemes.

Wire layout (bit-identical to the Rust reference, ``reference proof/mod.rs:23-85``)::

    [version:u8][scheme:u8][proof_len:u32 LE][commitment_len:u32 LE][proof][commitment]

``PROOF_VERSION`` is 2 (``proof/mod.rs:3``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .encoding import u32_le
from .errors import InvalidProofFormat
from .limits import (
    MAX_COMMITMENT_BYTES,
    MAX_PROOF_PAYLOAD_BYTES,
    MAX_PROOF_TOTAL_BYTES,
)

PROOF_VERSION = 2

# Scheme identifiers (proof/range_proof.rs:8 etc.)
SCHEME_RANGE = 1
SCHEME_EQUALITY = 2
SCHEME_THRESHOLD = 3
SCHEME_MEMBERSHIP = 4
SCHEME_IMPROVEMENT = 5
SCHEME_CONSISTENCY = 6

SCHEME_NAMES = {
    SCHEME_RANGE: "range",
    SCHEME_EQUALITY: "equality",
    SCHEME_THRESHOLD: "threshold",
    SCHEME_MEMBERSHIP: "membership",
    SCHEME_IMPROVEMENT: "improvement",
    SCHEME_CONSISTENCY: "consistency",
}


@dataclass
class Proof:
    """The common proof envelope (reference ``Proof`` struct, proof/mod.rs:6-11)."""

    version: int
    scheme: int
    proof: bytes
    commitment: bytes

    @classmethod
    def new(cls, scheme: int, proof: bytes, commitment: bytes) -> "Proof":
        return cls(PROOF_VERSION, scheme, bytes(proof), bytes(commitment))

    def to_bytes(self) -> bytes:
        # Avoid producing invalid encodings due to u32 truncation
        # (mirrors proof/mod.rs:24-27: returns empty on overflow).
        if len(self.proof) > 0xFFFFFFFF or len(self.commitment) > 0xFFFFFFFF:
            return b""
        return (
            bytes([self.version & 0xFF, self.scheme & 0xFF])
            + u32_le(len(self.proof))
            + u32_le(len(self.commitment))
            + self.proof
            + self.commitment
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proof":
        data = bytes(data)
        if len(data) > MAX_PROOF_TOTAL_BYTES:
            raise InvalidProofFormat(
                f"proof too large: max {MAX_PROOF_TOTAL_BYTES} bytes"
            )
        if len(data) < 10:
            raise InvalidProofFormat("proof too short for header")
        version = data[0]
        scheme = data[1]
        proof_len = int.from_bytes(data[2:6], "little")
        comm_len = int.from_bytes(data[6:10], "little")
        if proof_len > MAX_PROOF_PAYLOAD_BYTES or comm_len > MAX_COMMITMENT_BYTES:
            raise InvalidProofFormat("proof or commitment payload exceeds limit")
        total = 10 + proof_len + comm_len
        if len(data) != total:
            raise InvalidProofFormat("proof byte length mismatch")
        return cls(
            version,
            scheme,
            data[10 : 10 + proof_len],
            data[10 + proof_len :],
        )
