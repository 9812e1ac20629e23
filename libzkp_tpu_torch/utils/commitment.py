"""Commitment helpers (SHA-256 and MiMC based).

Copy of the JAX package's ``libzkp_tpu/utils/commitment.py`` (mirroring the
Rust reference's ``utils/commitment.rs``).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

from ..ops.mimc import fr_to_commitment, mimc_hash_native
from .encoding import u64_le
from .errors import InvalidInput, InvalidProofFormat


def commit_value(value: int) -> bytes:
    """SHA-256 of u64 LE (commitment.rs:6-10) — Bulletproofs-based proofs."""
    return hashlib.sha256(u64_le(value)).digest()


def commit_value_snark(value: int) -> bytes:
    """MiMC-5 commitment over BN254 Fr, 32-byte canonical LE (commitment.rs:14-16)."""
    return fr_to_commitment(mimc_hash_native(value))


def commit_values(values: Sequence[int]) -> bytes:
    h = hashlib.sha256()
    for v in values:
        h.update(u64_le(v))
    return h.digest()


def commit_with_context(values: Sequence[int], context: bytes) -> bytes:
    h = hashlib.sha256()
    h.update(bytes(context))
    for v in values:
        h.update(u64_le(v))
    return h.digest()


def commit_improvement(old: int, new: int) -> bytes:
    """SHA256("libzkp_improvement_v1" || old_le || new_le) (commitment.rs:38-50)."""
    if new <= old:
        raise InvalidInput("new value must be greater than old")
    h = hashlib.sha256()
    h.update(b"libzkp_improvement_v1")
    h.update(u64_le(old))
    h.update(u64_le(new))
    return h.digest()


def validate_improvement_commitment(commitment: bytes, old: int, new: int) -> None:
    if len(commitment) != 32:
        raise InvalidProofFormat("invalid improvement commitment size")
    if bytes(commitment) != commit_improvement(old, new):
        raise InvalidProofFormat("improvement commitment mismatch")
