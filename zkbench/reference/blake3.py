"""BLAKE3-256 in pure Python (frozen copy of the port's golden tier).
"""

from __future__ import annotations

import struct


IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024
MASK32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        cv[0], cv[1], cv[2], cv[3],
        cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    return [
        (state[i] ^ state[i + 8]) & MASK32 for i in range(8)
    ] + [(state[i + 8] ^ cv[i]) & MASK32 for i in range(8)]


def _words_from_block(block: bytes):
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return struct.unpack("<16I", block)


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool):
    """Chaining value of one ≤1024-byte chunk."""
    cv = list(IV)
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    out16 = None
    for i, blk in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        out16 = _compress(cv, _words_from_block(blk), chunk_counter, len(blk), flags)
        cv = out16[:8]
    return cv, out16


def _parent_cv(left_cv, right_cv, is_root: bool):
    block_words = tuple(left_cv) + tuple(right_cv)
    flags = PARENT | (ROOT if is_root else 0)
    out16 = _compress(list(IV), block_words, 0, BLOCK_LEN, flags)
    return out16[:8], out16


def blake3_256_py(data: bytes) -> bytes:
    """BLAKE3 with 32-byte output."""
    data = bytes(data)
    n_chunks = max(1, (len(data) + CHUNK_LEN - 1) // CHUNK_LEN)
    if n_chunks == 1:
        _, out16 = _chunk_cv(data, 0, is_root=True)
        return struct.pack("<8I", *out16[:8])
    # Build the binary tree over chunk chaining values.
    cvs = []
    for i in range(n_chunks):
        cv, _ = _chunk_cv(data[i * CHUNK_LEN : (i + 1) * CHUNK_LEN], i, is_root=False)
        cvs.append(cv)
    # BLAKE3 tree: left subtree is the largest power of two < n
    def merge(nodes, is_root):
        if len(nodes) == 1:
            return nodes[0], None
        split = 1
        while split * 2 < len(nodes):
            split *= 2
        left, _ = merge(nodes[:split], False)
        right, _ = merge(nodes[split:], False)
        return _parent_cv(left, right, is_root)

    _, out16 = merge(cvs, True)
    return struct.pack("<8I", *out16[:8])


def merge_digests_py(left: bytes, right: bytes) -> bytes:
    """Merkle node combine: BLAKE3 of the 64-byte concatenation.

    Matches winterfell's ``Blake3_256::merge`` (hash of two digests).
    """
    return blake3_256_py(left + right)


blake3_256 = blake3_256_py
merge_digests = merge_digests_py
