"""MiMC-5 hash over BN254 Fr (the host golden tier).

Copy of the host part of the JAX package's ``libzkp_tpu/ops/mimc.py``,
mirroring the Rust reference (its ``src/backend/snark.rs:182-221``):

* 110 rounds of ``x <- (x + c_i)^5`` over BN254 Fr;
* round constants ``SHA256(b"libzkp_mimc_v1:" || u64_le(i))`` reduced from
  LE bytes mod r;
* 32-byte commitments are the canonical little-endian Fr serialization.

The port keeps no memo of hashed values. The device MiMC batch is not ported
yet.
"""

from __future__ import annotations

import functools
import hashlib

from .field import BN254_FR

MIMC_ROUNDS = 110


@functools.lru_cache(maxsize=1)
def mimc_constants() -> tuple:
    """Round constants as Python ints."""
    out = []
    for i in range(MIMC_ROUNDS):
        h = hashlib.sha256(b"libzkp_mimc_v1:" + i.to_bytes(8, "little")).digest()
        out.append(BN254_FR.from_le_bytes_mod(h))
    return tuple(out)


def mimc_hash_native(value: int) -> int:
    """Host-scalar MiMC-5 of ``value`` mod r."""
    p = BN254_FR.p
    x = value % p
    for c in mimc_constants():
        x = pow((x + c) % p, 5, p)
    return x


def fr_to_commitment(f: int) -> bytes:
    """Canonical 32-byte LE serialization of an Fr element."""
    return int(f).to_bytes(32, "little")


def fr_from_commitment(data: bytes):
    """Inverse of :func:`fr_to_commitment`; ``None`` if non-canonical."""
    if len(data) != 32:
        return None
    return BN254_FR.from_le_bytes_canonical(data)
