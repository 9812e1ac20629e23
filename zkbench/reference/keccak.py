"""Keccak-f[1600] permutation in pure Python (the STROBE sponge of the
Merlin transcript)."""

from __future__ import annotations

MASK64 = (1 << 64) - 1

ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

ROTATION = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & MASK64


def keccak_f1600(lanes):
    """Permute a 25-lane (5x5, lane-major x + 5*y) uint64 state in place."""
    a = lanes
    for rc in ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], ROTATION[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & MASK64 & b[(x + 2) % 5 + 5 * y])
        # iota
        a[0] ^= rc
    return a


def keccak_f1600_bytes(state: bytearray) -> None:
    """Permute a 200-byte state buffer in place (little-endian lanes)."""
    lanes = [int.from_bytes(state[i * 8 : i * 8 + 8], "little") for i in range(25)]
    keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[i * 8 : i * 8 + 8] = lane.to_bytes(8, "little")
