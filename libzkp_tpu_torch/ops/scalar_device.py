"""Device scalar arithmetic mod l (the Ristretto group order) on torch lanes.

Port of the JAX package's ``libzkp_tpu/ops/scalar_device.py``. Over
``(..., n, B)`` fold-limb tensors (:mod:`.limbfold`) it provides the ring ops
(the generic ``FieldOps``), Fermat inversion x^(l-2), reduction of 64-byte
transcript challenges, and the scalar -> radix-256 digit-window pipeline that
feeds the MSM. The windows are not canonical: the MSM takes any 256-bit
representative v ≡ s (mod l), since every basis point has order l. Strict
(non-negative, < 2^12) limbs come from two signed folds at 2^252 ≡ -δ, a +4l
bias and n + 2 carry passes.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from .ed25519 import L as L_ORDER
from .limbfold import LIMB_BITS, FieldOps, get_fold_ctx, int_to_limbs

DELTA = L_ORDER - (1 << 252)  # l = 2^252 + DELTA

_FOLD_LIMB = 252 // LIMB_BITS  # 21: limb index whose base is exactly 2^252


class ScalarDeviceCtx:
    """Host-side constant pack for the mod-l device engine."""

    # extra const row indices (after ONE + FOLD rows)
    IDX_DELTA = 0
    IDX_BIAS = 1
    IDX_C256 = 2

    def __init__(self):
        self.ctx = get_fold_ctx(L_ORDER)
        self.n = self.ctx.n  # 24
        assert _FOLD_LIMB * LIMB_BITS == 252 and _FOLD_LIMB < self.n
        self.delta_limbs = int_to_limbs(DELTA, self.n)
        self.bias_limbs = int_to_limbs(4 * L_ORDER, self.n)
        self.c256_limbs = int_to_limbs(pow(2, 256, L_ORDER), self.n)
        # A bias redistributed over floors (to cut the n + 2 borrow-cascade
        # passes of strict_digit_windows) cannot work for l: see the note at
        # the JAX package's ops/scalar_device.py:46-53.
        # consts block rows: [ONE, FOLD(n+2), delta, bias, c256]
        self.consts_np = self.ctx.consts_block(
            [self.delta_limbs, self.bias_limbs, self.c256_limbs]
        )

    def field(self, consts: torch.Tensor) -> FieldOps:
        return FieldOps(self.n, consts)

    # -- host codecs -------------------------------------------------------
    def encode(self, vals) -> np.ndarray:
        """ints -> (len, n) canonical limbs (host)."""
        return self.ctx.encode_ints([v % L_ORDER for v in vals])

    def decode(self, arr) -> List[int]:
        return [v % L_ORDER for v in self.ctx.decode(arr)]


@functools.lru_cache(maxsize=None)
def get_scalar_ctx() -> ScalarDeviceCtx:
    return ScalarDeviceCtx()


def fold252(f: FieldOps, sc: ScalarDeviceCtx, x: torch.Tensor) -> torch.Tensor:
    """One signed fold: replaces the 2^252-and-up part of x via
    2^252 ≡ -delta (mod l). Relaxed limbs in and out."""
    hi = x[..., _FOLD_LIMB:, :]  # 2^252 units
    acc = x.clone()
    acc[..., _FOLD_LIMB:, :] = 0
    delta = f.extra_const(ScalarDeviceCtx.IDX_DELTA)  # (n, 1)
    for j in range(x.shape[-2] - _FOLD_LIMB):
        acc = acc - hi[..., j : j + 1, :] * _shift_rows(delta, j)
    return f.carry(f.carry(acc))


def _shift_rows(col: torch.Tensor, j: int) -> torch.Tensor:
    """delta * 2^(12 j) as a limb column: shift rows down by j (drop top)."""
    if j == 0:
        return col
    out = torch.zeros_like(col)
    out[j:] = col[:-j]
    return out


def strict_digit_windows(f: FieldOps, sc: ScalarDeviceCtx, x: torch.Tensor) -> torch.Tensor:
    """Relaxed mod-l limbs (..., n, B) -> radix-256 digit windows.

    Returns (32, ..., B) int32 digit rows, HIGH window first, representing a
    non-negative value < 2^256 congruent to x mod l (not canonical).
    """
    n = sc.n
    x = f.carry(f.carry(f.carry(x)))
    x = fold252(f, sc, x)          # |value| < 2^252 + 2^138
    x = fold252(f, sc, x)          # value in (-2^138, 2^252)
    x = x + f.extra_const(ScalarDeviceCtx.IDX_BIAS)  # + 4l: (0, 2^254.4)
    # strict normalization: value >= 0 ==> <= n+2 passes settle all borrows
    for _ in range(n + 2):
        x = f.carry(x)
    # repack strict 12-bit limbs -> 8-bit bytes (LE), static shifts
    return torch.stack(_byte_rows(x, 32)[::-1], dim=0)  # high window first


def _byte_rows(x: torch.Tensor, nbytes: int) -> list:
    """Strict 12-bit limbs (..., n, B) -> list of nbytes (..., B) byte rows."""
    n = x.shape[-2]
    rows = []
    for j in range(nbytes):
        i, off = divmod(8 * j, LIMB_BITS)
        if i >= n:
            rows.append(torch.zeros_like(x[..., 0, :]))
            continue
        b = x[..., i, :] >> off
        take = LIMB_BITS - off
        if take < 8 and i + 1 < n:
            b = b | (x[..., i + 1, :] << take)
        rows.append(b & 0xFF)
    return rows


# the exponent l - 2 in 4-bit windows, top window first
_INV_W = 4
_INV_DIGITS = [
    ((L_ORDER - 2) >> (_INV_W * (63 - i))) & ((1 << _INV_W) - 1) for i in range(64)
]


def inv_device(f: FieldOps, x: torch.Tensor) -> torch.Tensor:
    """x^(l-2) — Fermat inversion mod l, 4-bit fixed windows.

    15 precomputed powers, then 63 steps of (4 squares + one multiply by the
    window's power): the JAX version's ``lax.scan`` as a Python loop."""
    one = torch.zeros_like(x)
    one[..., 0, :] = 1
    pows = [one, x]
    for _ in range(2, 1 << _INV_W):
        pows.append(f.mul(pows[-1], x))
    acc = pows[_INV_DIGITS[0]]
    for d in _INV_DIGITS[1:]:
        for _ in range(_INV_W):
            acc = f.mul(acc, acc)
        acc = f.mul(acc, pows[d])
    return acc


def reduce_wide(f: FieldOps, sc: ScalarDeviceCtx, byte_rows: torch.Tensor) -> torch.Tensor:
    """(64, B) transcript bytes (LE, int32) -> relaxed mod-l limbs (n, B).

    v = lo(32 bytes) + hi(32 bytes) * (2^256 mod l).
    """
    n = sc.n

    def pack(rows):  # 32 byte rows -> (n, B) limbs
        limbs = []
        for i in range(n):
            j, off = divmod(LIMB_BITS * i, 8)
            if j >= 32:
                limbs.append(torch.zeros_like(rows[0]))
                continue
            v = rows[j] >> off
            got = 8 - off
            jj = j + 1
            while got < LIMB_BITS and jj < 32:
                v = v | (rows[jj] << got)
                got += 8
                jj += 1
            limbs.append(v & ((1 << LIMB_BITS) - 1))
        return torch.stack(limbs, dim=0)

    rows = byte_rows.to(torch.int32)
    lo = pack(rows[:32])
    hi = pack(rows[32:])
    c256 = f.extra_const(ScalarDeviceCtx.IDX_C256)
    return f.add(lo, f.mul(hi, c256.expand_as(hi)))
