"""The BLAKE3 compression function over many lanes at once, in torch.

Port of ``_compress_vec`` of the JAX package's
``libzkp_tpu/ops/blake3_device.py``: one compression a lane, every lane in
step, on the device of its inputs. The card route of the STARK prover runs
it over every trace leaf of a batch (``ops/stark_device.py``); each leaf is
one 16-byte f128 element, a standalone BLAKE3 of one block.

Words: torch has no uint32 add or shift on the CPU, so each 32-bit word is
carried in int64 in [0, 2^32) and every sum is masked back; a rotation of a
word in that range shifts left by at most 31 bits, which int64 holds. The
JAX package's ``hash_leaves_device`` and ``merkle_tree_device`` (the leaf
digests and every level of a tree in one program) serve an opt-in route
the port does not carry; they are not ported.
"""

from __future__ import annotations

import torch

from .blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT

MASK32 = 0xFFFFFFFF
# a leaf, and every hash of the Merkle tier, is a standalone BLAKE3 of at
# most 64 bytes: one chunk of one block, counter 0
STANDALONE = CHUNK_START | CHUNK_END | ROOT


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK32


def compress_vec(cv: torch.Tensor, m: torch.Tensor, counter: int, block_len: int,
                 flags: int) -> torch.Tensor:
    """The compression function of each lane: chaining values ``cv`` (L, 8)
    and message words ``m`` (L, 16), int64 words in [0, 2^32), ->
    (L, 8) output chaining values (the first 8 words of the state, each the
    xor of its two halves). ``counter``, ``block_len`` and ``flags`` are the
    same for every lane."""
    state = [cv[:, i] for i in range(8)] + [
        torch.full_like(cv[:, 0], v)
        for v in (IV[0], IV[1], IV[2], IV[3], counter & MASK32, (counter >> 32) & MASK32,
                  block_len, flags)
    ]
    msg = [m[:, i] for i in range(16)]

    def g(a, b, c, d, mx, my):
        state[a] = (state[a] + state[b] + mx) & MASK32
        state[d] = _rotr(state[d] ^ state[a], 16)
        state[c] = (state[c] + state[d]) & MASK32
        state[b] = _rotr(state[b] ^ state[c], 12)
        state[a] = (state[a] + state[b] + my) & MASK32
        state[d] = _rotr(state[d] ^ state[a], 8)
        state[c] = (state[c] + state[d]) & MASK32
        state[b] = _rotr(state[b] ^ state[c], 7)

    for r in range(7):
        g(0, 4, 8, 12, msg[0], msg[1])
        g(1, 5, 9, 13, msg[2], msg[3])
        g(2, 6, 10, 14, msg[4], msg[5])
        g(3, 7, 11, 15, msg[6], msg[7])
        g(0, 5, 10, 15, msg[8], msg[9])
        g(1, 6, 11, 12, msg[10], msg[11])
        g(2, 7, 8, 13, msg[12], msg[13])
        g(3, 4, 9, 14, msg[14], msg[15])
        if r < 6:
            msg = [msg[MSG_PERMUTATION[i]] for i in range(16)]
    return torch.stack([state[i] ^ state[i + 8] for i in range(8)], dim=1)


def hash_blocks(m: torch.Tensor, block_len: int) -> torch.Tensor:
    """BLAKE3-256 of each lane's one-block message: ``m`` (L, 16) int64
    words of the zero-padded 64-byte block, ``block_len`` the message's
    bytes (at most 64) -> (L, 8) int64 digest words, little-endian."""
    iv = torch.tensor(IV, dtype=torch.int64, device=m.device).expand(m.shape[0], 8)
    return compress_vec(iv, m, 0, block_len, STANDALONE)
