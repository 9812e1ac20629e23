"""Fiat–Shamir random coin for the STARK backend.

Frozen copy of the port's random coin. Mirrors the
role of winterfell's ``DefaultRandomCoin<Blake3_256>`` (the reference's
stark.rs:5,112): a seed digest, reseeded with each commitment, from which
field elements, integers and PoW checks are drawn.
"""

from __future__ import annotations

from typing import List

from .blake3 import blake3_256, merge_digests


class RandomCoin:
    def __init__(self, seed_material: bytes):
        self.seed = blake3_256(seed_material)
        self.counter = 0

    def reseed(self, digest: bytes) -> None:
        self.seed = merge_digests(self.seed, bytes(digest))
        self.counter = 0

    def _next_digest(self) -> bytes:
        self.counter += 1
        return blake3_256(self.seed + self.counter.to_bytes(8, "little"))

    def draw_felt(self, F) -> int:
        """Uniform field element by rejection sampling from the digest stream."""
        for _ in range(1000):
            h = self._next_digest()
            v = int.from_bytes(h[: F.nbytes], "little")
            if F.nbits % 8:
                v &= (1 << F.nbits) - 1
            if v < F.p:
                return v
        raise RuntimeError("random coin failed to draw a field element")

    def draw_felts(self, F, count: int) -> List[int]:
        return [self.draw_felt(F) for _ in range(count)]

    def draw_integers(self, count: int, domain_size: int, nonce: int) -> List[int]:
        """Distinct query positions in [0, domain_size), sorted ascending."""
        assert domain_size & (domain_size - 1) == 0
        self.reseed(blake3_256(nonce.to_bytes(8, "little")))
        mask = domain_size - 1
        seen = set()
        out = []
        for _ in range(1000):
            if len(out) >= count:
                break
            h = self._next_digest()
            v = int.from_bytes(h[:8], "little") & mask
            if v not in seen:
                seen.add(v)
                out.append(v)
        return sorted(out)

    def check_leading_zeros(self, nonce: int, grinding_bits: int) -> bool:
        """Proof-of-work check (grinding factor)."""
        if grinding_bits == 0:
            return True
        h = blake3_256(self.seed + nonce.to_bytes(8, "little"))
        v = int.from_bytes(h[:8], "big")
        return v >> (64 - grinding_bits) == 0
