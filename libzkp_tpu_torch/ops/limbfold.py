"""Fold-reduction limb field arithmetic on torch int32 tensors.

Port of the JAX package's ``libzkp_tpu/ops/limbfold.py``:

* **Plain representation** (no Montgomery domain): a value is its relaxed
  signed 12-bit limbs, shape ``(..., n, L)`` — limbs on the second-to-last
  axis, batch lanes on the last.
* **Fold reduction**: the double-width schoolbook product T (2n+2 columns) is
  carried twice (no-wrap) and the high columns are folded back with the
  constant matrix ``FOLD[i] = limbs(2^(12(n+i)) mod p)``, then three wrap
  carries restore the relaxed invariant.
* Bounds (n = 24, relaxed |limb| <= ~2^13.1): conv columns < 2^31, fold
  accumulator < 2^29.

Every operation is the JAX version's, in the same order, so the limbs are
bit-identical to it (int32 wraps alike in both, and every sum here is exact
under the bounds). The CUDA kernels (``csrc/fold_curves.cuh``) run the same
schedule per lane.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    assert x == 0, "value does not fit in limb count"
    return out


def ints_to_limb_rows(vals: Sequence[int], n: int) -> np.ndarray:
    """Non-negative ints < 2^(12n) -> (len, n) strict int32 limbs.

    Vectorized form of ``int_to_limbs`` over many values: bytes in, 12-bit
    fields out by numpy shifts."""
    nbytes = (LIMB_BITS * n + 7) // 8 + 1
    return bytes_to_limb_rows(b"".join(int(v).to_bytes(nbytes, "little") for v in vals), nbytes, n)


def bytes_to_limb_rows(buf: bytes, width: int, n: int) -> np.ndarray:
    """Non-negative little-endian values of ``width`` bytes each, below
    2^(12n), -> (count, n) strict int32 limbs: :func:`ints_to_limb_rows`
    for values that are bytes already (a native call's output rows)."""
    nbytes = (LIMB_BITS * n + 7) // 8 + 1
    if width > nbytes:
        raise ValueError(f"{width}-byte values do not fit {n} limbs")
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, width)
    b = np.zeros((raw.shape[0], nbytes), dtype=np.int32)
    b[:, :width] = raw
    out = np.empty((raw.shape[0], n), dtype=np.int32)
    for i in range(n):
        j, off = divmod(LIMB_BITS * i, 8)
        out[:, i] = ((b[:, j] | (b[:, j + 1] << 8)) >> off) & LIMB_MASK
    return out


def limb_rows_to_ints(flat: np.ndarray, p: int) -> list:
    """(rows, n) relaxed signed 12-bit limbs -> canonical ints mod p.

    Copy of the JAX package's ``ops/limb.py:limb_rows_to_ints``: limbs pair
    into 24-bit words, a numpy carry chain makes every low word a clean
    3-byte group, then each value is one ``int.from_bytes`` + one ``% p``.
    """
    flat = np.asarray(flat, dtype=np.int64)
    rows = flat.shape[0]
    if rows == 0:
        return []
    if flat.shape[1] % 2:
        flat = np.pad(flat, ((0, 0), (0, 1)))
    w = flat[:, 0::2] + (flat[:, 1::2] << LIMB_BITS)  # (rows, nw) signed words
    nw = w.shape[1]
    for k in range(nw - 1):  # carry left->right; >> handles negatives
        w[:, k + 1] += w[:, k] >> 24
        w[:, k] &= 0xFFFFFF
    tops = w[:, nw - 1]
    stride = (nw - 1) * 3
    low = w[:, : nw - 1].astype(np.uint32)
    b = np.empty((rows, stride), dtype=np.uint8)
    b[:, 0::3] = low & 0xFF
    b[:, 1::3] = (low >> 8) & 0xFF
    b[:, 2::3] = (low >> 16) & 0xFF
    buf = b.tobytes()
    shift = 24 * (nw - 1)
    return [
        (int.from_bytes(buf[i * stride : (i + 1) * stride], "little")
         + (int(tops[i]) << shift)) % p
        for i in range(rows)
    ]


class FoldCtx:
    """Per-prime constants for the fold field (host side, numpy only)."""

    def __init__(self, p: int):
        self.p = p
        # >= 9 bits of slack above p, rounded up to a multiple of 8 as in the
        # JAX package (n = 24 for every prime the port uses), so limbs compare
        # exactly with the reference
        n_min = (p.bit_length() + 9 + LIMB_BITS - 1) // LIMB_BITS
        self.n = (n_min + 7) // 8 * 8
        n = self.n
        assert (1 << (LIMB_BITS * n)) >> 8 >= p, "insufficient limb slack"
        self.ONE = int_to_limbs((1 << (LIMB_BITS * n)) % p, n)  # wrap constant
        self.FOLD = np.stack(
            [int_to_limbs((1 << (LIMB_BITS * (n + i))) % p, n) for i in range(n + 2)]
        )

    def consts_block(self, extra: Sequence[np.ndarray] = ()) -> np.ndarray:
        """Rows: [ONE, FOLD (n+2 rows), *extra] — shape (n+3+len(extra), n)."""
        rows = [self.ONE[None, :], self.FOLD]
        for e in extra:
            rows.append(np.asarray(e, dtype=np.int32)[None, :])
        return np.concatenate(rows, axis=0).astype(np.int32)

    def encode_value(self, v: int) -> np.ndarray:
        return int_to_limbs(int(v) % self.p, self.n)

    def encode_ints(self, vals: Sequence[int]) -> np.ndarray:
        """(B, n) canonical int32 limbs."""
        return ints_to_limb_rows([int(v) % self.p for v in vals], self.n)

    def decode(self, arr) -> List[int]:
        """(..., n) relaxed limbs (host numpy) -> canonical ints mod p."""
        a = np.asarray(arr, dtype=np.int64)
        return limb_rows_to_ints(a.reshape(-1, self.n), self.p)


@functools.lru_cache(maxsize=None)
def get_fold_ctx(p: int) -> FoldCtx:
    return FoldCtx(p)


def schoolbook_outer(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """The 2n + 2 schoolbook columns (the top three zero) of (..., n, L)
    limbs, from one outer product: row i of the (n, 2n) zero-padded product,
    laid out with row stride 2n - 1, puts a_i * b_j in column i + j, so a sum
    over rows gives every column."""
    lead = a.shape[:-2]
    L = a.shape[-1]
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., n_i, n_j, L)
    prod = F.pad(prod, (0, 0, 0, n)).reshape(*lead, 2 * n * n, L)
    skew = prod[..., : n * (2 * n - 1), :].reshape(*lead, n, 2 * n - 1, L)
    return F.pad(skew.sum(-3, dtype=torch.int32), (0, 0, 0, 3))


def schoolbook_rows(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`schoolbook_outer`'s columns accumulated row by row: a_i * b
    lands in columns i .. i + n - 1 (wrapping int32 adds are associative, so
    the limbs are the same)."""
    T = a.new_zeros(*a.shape[:-2], 2 * n + 2, a.shape[-1])
    for i in range(n):
        T[..., i : i + n, :] += a[..., i : i + 1, :] * b
    return T


class FieldOps:
    """Value-level field ops on (..., n, L) int32 tensors.

    Built from a consts block tensor (``FoldCtx.consts_block``) on the device
    the operands live on. ``one_l`` is (n, 1), ``fold_c`` is (n+2, n).
    """

    def __init__(self, n: int, consts: torch.Tensor):
        self.n = n
        self.one_l = consts[0][:, None]
        self.fold_c = consts[1 : n + 3]
        self._extra = consts[n + 3 :]

    def extra_const(self, idx: int) -> torch.Tensor:
        """Extra constant row idx as (n, 1), broadcastable."""
        return self._extra[idx][:, None]

    # -- carries -------------------------------------------------------------
    def carry(self, x: torch.Tensor) -> torch.Tensor:
        """One wrap-carry pass; preserves value mod p, relaxes limbs."""
        hi = x >> LIMB_BITS
        out = (x & LIMB_MASK) + hi[..., -1:, :] * self.one_l
        out[..., 1:, :] += hi[..., :-1, :]
        return out

    def _carry_nw(self, x: torch.Tensor) -> torch.Tensor:
        """No-wrap pass over a wide (column) array; the top carry is dropped
        (callers allocate a spare top column that absorbs it)."""
        hi = x >> LIMB_BITS
        out = x & LIMB_MASK
        out[..., 1:, :] += hi[..., :-1, :]
        return out

    # -- ring ops --------------------------------------------------------------
    def add(self, a, b):
        return self.carry(a + b)

    def sub(self, a, b):
        return self.carry(a - b)

    def smul(self, a, k: int):
        """Multiply by small plain int (|k| <= ~2^16); two carry passes."""
        return self.carry(self.carry(a * k))

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Full product, conv -> 2 no-wrap carries -> fold -> 3 wrap carries.

        The 2n + 2 schoolbook columns are exact int32 sums, so their limbs do
        not depend on how they are formed: :func:`schoolbook_outer` on a CUDA
        device (few operations: the eager paths there are bound by their
        launches), :func:`schoolbook_rows` on the CPU (no (n, n) product
        buffer: about twice as fast there)."""
        n = self.n
        a, b = torch.broadcast_tensors(a, b)
        columns = schoolbook_rows if a.device.type == "cpu" else schoolbook_outer
        T = columns(a, b, n)
        T = self._carry_nw(self._carry_nw(T))
        folded = (T[..., n:, :].unsqueeze(-2) * self.fold_c[:, :, None]).sum(
            -3, dtype=torch.int32
        )
        return self.carry(self.carry(self.carry(T[..., :n, :] + folded)))
