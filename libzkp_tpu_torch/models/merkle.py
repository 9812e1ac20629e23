"""BLAKE3 Merkle tree vector commitment (host tier).

Port of the JAX package's ``libzkp_tpu/models/merkle.py``: the STARK
backend's vector commitment, mirroring the role of winterfell's
``MerkleTree<Blake3_256>`` (the reference's stark.rs:5,111). The levels
above the leaves and the leaf digests of element rows run on the native
tier (``blake3_merkle_levels``, ``blake3_batch``), as the reference's do
when its library is built; the card route hashes its trace leaves on the
device (``ops/stark_device.py``), and :func:`hash_element_rows` hashes
rows on a device when it is given one (the JAX package's opt-in
``LIBZKP_DEVICE_HASH=1``, as an argument).
"""

from __future__ import annotations

from typing import List, Sequence

from .. import native
from ..ops.blake3 import blake3_256, merge_digests
from ..ops.blake3_device import hash_leaves_device


class MerkleTree:
    """Binary Merkle tree over 32-byte leaf digests (power-of-two count)."""

    def __init__(self, leaves: Sequence[bytes]):
        n = len(leaves)
        assert n > 0 and n & (n - 1) == 0, "leaf count must be a power of two"
        self.leaves = [bytes(l) for l in leaves]
        self.levels: List[List[bytes]] = [self.leaves]
        self.levels.extend(native.blake3_merkle_levels(self.leaves))

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def open(self, index: int) -> List[bytes]:
        """Sibling path from leaf to root."""
        path = []
        for level in self.levels[:-1]:
            sib = index ^ 1
            path.append(level[sib])
            index >>= 1
        return path

    def open_many(self, positions: Sequence[int]) -> List[bytes]:
        """Batched opening: the minimal sibling-node set for ``positions``.

        Nodes are emitted level-by-level, left-to-right — the deterministic
        dual of :meth:`verify_many`. Mirrors winterfell's BatchMerkleProof
        role (compresses shared path prefixes across queries).
        """
        nodes: List[bytes] = []
        known = sorted(set(positions))
        for level in self.levels[:-1]:
            nxt: List[int] = []
            i = 0
            while i < len(known):
                idx = known[i]
                sib = idx ^ 1
                if i + 1 < len(known) and known[i + 1] == sib:
                    i += 2
                else:
                    nodes.append(level[sib])
                    i += 1
                nxt.append(idx >> 1)
            known = nxt
        return nodes

    @staticmethod
    def verify_many(
        root: bytes,
        depth: int,
        positions: Sequence[int],
        leaves: Sequence[bytes],
        nodes: Sequence[bytes],
    ) -> bool:
        """Verify a batched opening produced by :meth:`open_many`.

        ``positions``/``leaves`` are parallel (positions must be sorted unique).
        """
        known = list(positions)
        if known != sorted(set(known)) or len(leaves) != len(known):
            return False
        values = {idx: bytes(l) for idx, l in zip(known, leaves)}
        stream = iter(nodes)
        try:
            for _ in range(depth):
                nxt: dict = {}
                i = 0
                while i < len(known):
                    idx = known[i]
                    sib = idx ^ 1
                    if i + 1 < len(known) and known[i + 1] == sib:
                        left, right = values[idx], values[sib]
                        i += 2
                    else:
                        sv = next(stream)
                        left, right = (
                            (values[idx], sv) if idx % 2 == 0 else (sv, values[idx])
                        )
                        i += 1
                    nxt[idx >> 1] = merge_digests(left, right)
                values = nxt
                known = sorted(values)
        except StopIteration:
            return False
        if next(stream, None) is not None:
            return False
        return len(values) == 1 and values.get(0) == root

    @staticmethod
    def num_batch_nodes(depth: int, positions: Sequence[int]) -> int:
        """Node count of a batched opening (for deserialization)."""
        known = sorted(set(positions))
        count = 0
        for _ in range(depth):
            nxt = []
            i = 0
            while i < len(known):
                idx = known[i]
                if i + 1 < len(known) and known[i + 1] == (idx ^ 1):
                    i += 2
                else:
                    count += 1
                    i += 1
                nxt.append(idx >> 1)
            known = nxt
        return count

    @staticmethod
    def verify(root: bytes, index: int, leaf: bytes, path: List[bytes]) -> bool:
        node = bytes(leaf)
        for sib in path:
            if index & 1:
                node = merge_digests(sib, node)
            else:
                node = merge_digests(node, sib)
            index >>= 1
        return node == root


def hash_elements(F, elements: Sequence[int]) -> bytes:
    """Digest of field elements: BLAKE3 over their LE byte concatenation.

    Mirrors winterfell ``ElementHasher::hash_elements`` semantics (elements
    serialized little-endian, fixed width).
    """
    data = b"".join(int(e).to_bytes(F.nbytes, "little") for e in elements)
    return blake3_256(data)


def hash_element_rows(F, rows: Sequence[Sequence[int]], *, device=None) -> List[bytes]:
    """:func:`hash_elements` over many rows: with ``device`` ``None``, one
    native batch call when the rows have one length; with a device, one
    ``blake3`` launch there (``ops.blake3_device.hash_leaves_device``), which
    raises on rows of unequal length or over one 64-byte block."""
    if not rows:
        return []
    nb = F.nbytes
    items = [b"".join(int(e).to_bytes(nb, "little") for e in row) for row in rows]
    if device is not None:
        return hash_leaves_device(items, device=device)
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        return [blake3_256(x) for x in items]
    return native.blake3_batch(items, width * nb)
