"""Composite proofs and batch operation containers.

Copy of the JAX package's ``libzkp_tpu/utils/composition.py`` (the Rust
reference's ``utils/composition.rs``):

* ``CompositeProof``: N proofs + string->bytes metadata + SHA-256 integrity
  digest over domain ``b"COMPOSITE_PROOF:"`` (composition.rs:59-79); ``COMP``
  wire format with limits (<=1000 proofs/metadata, key <=1024 B,
  value <=65536 B).
* ``ProofBatch`` / ``BatchOperation``: the six deferred operations.

The integrity digest is unkeyed (detects corruption, not authentication) —
same caveats as the reference's doc comment.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .encoding import u32_le
from .envelope import Proof
from .errors import InvalidInput, InvalidProofFormat
from .limits import MAX_COMPOSITE_PROOF_BYTES


class CompositeProof:
    def __init__(self, proofs: List[Proof]):
        if not proofs:
            raise InvalidInput("cannot create composite proof from empty list")
        self.proofs = list(proofs)
        self.metadata: Dict[str, bytes] = {}
        self.composition_hash = self._compute_composition_hash(
            self.proofs, self.metadata
        )

    def add_metadata(self, key: str, value: bytes) -> None:
        self.metadata[key] = bytes(value)
        self.composition_hash = self._compute_composition_hash(
            self.proofs, self.metadata
        )

    @staticmethod
    def _compute_composition_hash(
        proofs: List[Proof], metadata: Dict[str, bytes]
    ) -> bytes:
        h = hashlib.sha256()
        h.update(b"COMPOSITE_PROOF:")
        h.update(u32_le(len(proofs)))
        for p in proofs:
            h.update(p.to_bytes())
        for k in sorted(metadata):
            v = metadata[k]
            kb = k.encode("utf-8")
            h.update(u32_le(len(kb)))
            h.update(kb)
            h.update(u32_le(len(v)))
            h.update(v)
        return h.digest()

    def to_bytes(self) -> bytes:
        out = bytearray(b"COMP")
        out += u32_le(len(self.proofs))
        out += u32_le(len(self.metadata))
        for p in self.proofs:
            pb = p.to_bytes()
            out += u32_le(len(pb))
            out += pb
        for k, v in self.metadata.items():
            kb = k.encode("utf-8")
            out += u32_le(len(kb))
            out += kb
            out += u32_le(len(v))
            out += v
        out += self.composition_hash
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompositeProof":
        data = bytes(data)
        if len(data) > MAX_COMPOSITE_PROOF_BYTES:
            raise InvalidProofFormat(
                f"composite proof too large: max {MAX_COMPOSITE_PROOF_BYTES} bytes"
            )
        if len(data) < 12:
            raise InvalidProofFormat(
                f"composite proof too short: expected at least 12 bytes, got {len(data)}"
            )
        if data[0:4] != b"COMP":
            raise InvalidProofFormat("invalid composite proof header")
        num_proofs = int.from_bytes(data[4:8], "little")
        num_metadata = int.from_bytes(data[8:12], "little")
        if num_proofs > 1000 or num_metadata > 1000:
            raise InvalidProofFormat(
                f"composite proof has too many items: proofs={num_proofs}, "
                f"metadata={num_metadata}"
            )
        offset = 12
        proofs: List[Proof] = []
        for _ in range(num_proofs):
            if offset + 4 > len(data):
                raise InvalidProofFormat("truncated proof length")
            plen = int.from_bytes(data[offset : offset + 4], "little")
            offset += 4
            if offset + plen > len(data):
                raise InvalidProofFormat("truncated proof data")
            proofs.append(Proof.from_bytes(data[offset : offset + plen]))
            offset += plen
        metadata: Dict[str, bytes] = {}
        for i in range(num_metadata):
            if offset + 4 > len(data):
                raise InvalidProofFormat(f"truncated metadata header at index {i}")
            klen = int.from_bytes(data[offset : offset + 4], "little")
            offset += 4
            if klen > 1024:
                raise InvalidProofFormat(f"metadata key too large at index {i}")
            if offset + klen > len(data):
                raise InvalidProofFormat(f"truncated metadata key at index {i}")
            try:
                key = data[offset : offset + klen].decode("utf-8")
            except UnicodeDecodeError:
                raise InvalidProofFormat(
                    f"invalid metadata key at index {i}: non-utf8 bytes"
                ) from None
            offset += klen
            if offset + 4 > len(data):
                raise InvalidProofFormat(f"truncated metadata value length at index {i}")
            vlen = int.from_bytes(data[offset : offset + 4], "little")
            offset += 4
            if vlen > 65536:
                raise InvalidProofFormat(f"metadata value too large at index {i}")
            if offset + vlen > len(data):
                raise InvalidProofFormat(f"truncated metadata value at index {i}")
            metadata[key] = data[offset : offset + vlen]
            offset += vlen
        end = offset + 32
        if end > len(data):
            raise InvalidProofFormat("missing composition hash")
        composition_hash = data[offset:end]
        if end != len(data):
            raise InvalidProofFormat(
                f"trailing bytes after composition hash: {len(data) - end} extra byte(s)"
            )
        expected = cls._compute_composition_hash(proofs, metadata)
        if composition_hash != expected:
            raise InvalidProofFormat("composition hash mismatch")
        out = cls.__new__(cls)
        out.proofs = proofs
        out.metadata = metadata
        out.composition_hash = composition_hash
        return out

    # -- verification (composition.rs:319-332) -----------------------------
    def verify_integrity(self) -> bool:
        return self.composition_hash == self._compute_composition_hash(
            self.proofs, self.metadata
        )

    def verify_cryptographic(self) -> bool:
        from ..models.schemes.dispatch import verify_proof_cryptographic

        return all(verify_proof_cryptographic(p) for p in self.proofs)

    def verify_full(self) -> bool:
        return self.verify_integrity() and self.verify_cryptographic()


# ---------------------------------------------------------------------------
# Batch operations (composition.rs:336-413)
# ---------------------------------------------------------------------------


@dataclass
class BatchOperation:
    kind: str  # range | equality | threshold | membership | improvement | consistency
    args: Tuple

    KINDS = ("range", "equality", "threshold", "membership", "improvement", "consistency")


@dataclass
class ProofBatch:
    operations: List[BatchOperation] = field(default_factory=list)

    def add_range_proof(self, value: int, min_v: int, max_v: int) -> None:
        self.operations.append(BatchOperation("range", (value, min_v, max_v)))

    def add_equality_proof(self, val1: int, val2: int) -> None:
        self.operations.append(BatchOperation("equality", (val1, val2)))

    def add_threshold_proof(self, values: List[int], threshold: int) -> None:
        self.operations.append(BatchOperation("threshold", (list(values), threshold)))

    def add_membership_proof(self, value: int, the_set: List[int]) -> None:
        self.operations.append(BatchOperation("membership", (value, list(the_set))))

    def add_improvement_proof(self, old: int, new: int) -> None:
        self.operations.append(BatchOperation("improvement", (old, new)))

    def add_consistency_proof(self, data: List[int]) -> None:
        self.operations.append(BatchOperation("consistency", (list(data),)))

    def __len__(self) -> int:
        return len(self.operations)

    def is_empty(self) -> bool:
        return not self.operations

    @classmethod
    def from_operations(cls, operations: List[BatchOperation]) -> "ProofBatch":
        return cls(list(operations))
