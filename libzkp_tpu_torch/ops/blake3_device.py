"""The device BLAKE3 tier: one-block leaf digests and Merkle trees on a card.

Port of the JAX package's ``libzkp_tpu/ops/blake3_device.py``.
:func:`compress_vec` is its ``_compress_vec``: one compression a lane, every
lane in step, in torch on the device of its inputs. It is the plain version
of the ``blake3`` kernel (``csrc/blake3.cu``, one lane a thread;
``kernels.blake3``), through which every hash of this module runs:
:func:`hash_blocks` hashes each lane's one-block message, a launch on CUDA
and :func:`compress_vec` on the CPU. Over it:

* :func:`hash_leaves_device`: BLAKE3-256 of equal-length byte rows of at
  most 64 bytes, one launch (the card route of the STARK prover hashes its
  trace leaves the same way, ``ops/stark_device.py``);
* :func:`merkle_tree_device`: the leaf digests and every level of a Merkle
  tree over a power-of-two count of rows, one launch for the leaves and one
  a level, each level reading the previous one's digests in place;
* :func:`rows_to_words`: the rows as zero-padded 64-byte blocks of 16
  little-endian u32 words, uploaded once.

Every hash is a standalone BLAKE3 of at most 64 bytes (one chunk of one
block, counter 0), as ``models/merkle.py``'s leaves and ``merge_digests``
are, so the digests equal the host tier's. The JAX package's jit and its
``LIBZKP_DEVICE_HASH_JIT`` switch have no counterpart: the route goes by the
device of the call.

Words: torch has no uint32 add or shift on the CPU, so each 32-bit word is
carried in int64 in [0, 2^32) and every sum is masked back; a rotation of a
word in that range shifts left by at most 31 bits, which int64 holds.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve
from . import kernels
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
    bytes (at most 64) -> (L, 8) int64 digest words, little-endian. One
    ``blake3`` launch on CUDA, :func:`compress_vec` on the CPU."""
    return kernels.blake3(m, block_len, STANDALONE)


def rows_to_words(rows: Sequence[bytes], device) -> torch.Tensor:
    """Equal-length byte rows of at most 64 bytes -> (B, 16) int64 words of
    their zero-padded 64-byte blocks, little-endian, on ``device`` (one
    upload). Raises ``AssertionError`` on a row over 64 bytes, as the JAX
    package's assert does, and ``ValueError`` on rows of unequal length
    (which the JAX package hashed with the first row's length)."""
    width = len(rows[0])
    if width > 64:
        raise AssertionError("single-block leaves only")
    if any(len(r) != width for r in rows):
        raise ValueError(f"the device BLAKE3 tier takes rows of one length, the first of {width} bytes")
    buf = np.zeros((len(rows), 64), dtype=np.uint8)
    buf[:, :width] = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(len(rows), width)
    return torch.from_numpy(buf.view("<u4").astype(np.int64)).to(device)


def _digests(words: torch.Tensor) -> List[bytes]:
    """(L, 8) int64 digest words on the host -> L 32-byte digests."""
    raw = words.numpy().astype("<u4").tobytes()
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]


def hash_leaves_device(rows: Sequence[bytes], *, device=None) -> List[bytes]:
    """BLAKE3-256 of equal-length byte rows of at most 64 bytes, one
    launch: the digests ``hash_element_rows`` gives on the host. ``device``
    defaults to the CUDA card; ``"cpu"`` runs the plain version."""
    words = rows_to_words(rows, resolve(device))
    return _digests(hash_blocks(words, len(rows[0])).cpu())


def merkle_tree_device(rows: Sequence[bytes], *, device=None) -> tuple:
    """(leaf digests, levels) of the Merkle tree over ``rows``, a power-of-two
    count above 1 of equal-length byte rows of at most 64 bytes: the leaf
    digests as :func:`hash_leaves_device` gives them and the levels above
    them, each a list of 32-byte digests, equal to
    ``MerkleTree(leaves).levels[1:]``. One launch for the leaves and one a
    level, one download. Raises ``AssertionError`` on another count, as the
    JAX package's assert does."""
    B = len(rows)
    if not (B > 1 and B & (B - 1) == 0):
        raise AssertionError(f"a Merkle tree takes a power-of-two count of rows above 1, not {B}")
    levels = [hash_blocks(rows_to_words(rows, resolve(device)), len(rows[0]))]
    while levels[-1].shape[0] > 1:  # parent i hashes digests 2i and 2i + 1 side by side
        levels.append(hash_blocks(levels[-1].view(-1, 16), 64))
    flat = _digests(torch.cat(levels).cpu())
    out, start = [], 0
    for lv in levels:
        out.append(flat[start : start + lv.shape[0]])
        start += lv.shape[0]
    return out[0], out[1:]
