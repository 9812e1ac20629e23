"""Bulletproofs generators: Pedersen (B, B_blinding) and the (G, H) chains
of dalek's ``BulletproofGens`` (frozen copy of the port's).
"""

from __future__ import annotations

import functools
import hashlib
from typing import Tuple

from . import ed25519 as ed


@functools.lru_cache(maxsize=1)
def pedersen_gens() -> Tuple[ed.Point, ed.Point]:
    """(B, B_blinding) of ``PedersenGens::default()``."""
    b = ed.BASEPOINT
    h = hashlib.sha3_512(ed.RISTRETTO_BASEPOINT_COMPRESSED).digest()
    b_blinding = ed.from_uniform_bytes(h)
    return b, b_blinding


def pedersen_commit(value: int, blinding: int) -> ed.Point:
    b, b_blinding = pedersen_gens()
    return ed.point_add(ed.scalar_mul(value, b), ed.scalar_mul(blinding, b_blinding))


@functools.lru_cache(maxsize=64)
def _chain(label: bytes, count: int) -> Tuple[ed.Point, ...]:
    shake = hashlib.shake_256()
    shake.update(b"GeneratorsChain")
    shake.update(label)
    stream = shake.digest(64 * count)
    return tuple(
        ed.from_uniform_bytes(stream[i * 64 : (i + 1) * 64]) for i in range(count)
    )


@functools.lru_cache(maxsize=32)
def bp_gens(n_bits: int, party: int = 0) -> Tuple[Tuple[ed.Point, ...], Tuple[ed.Point, ...]]:
    """(G, H) generator vectors for one party share (dalek ``share(party)``)."""
    g_label = bytes([ord("G")]) + party.to_bytes(4, "little")
    h_label = bytes([ord("H")]) + party.to_bytes(4, "little")
    return _chain(g_label, n_bits), _chain(h_label, n_bits)
