"""Batched Ristretto255 encode and decode (RFC 9496) on fold-field lanes.

Port of the JAX package's Ristretto device programs in
``libzkp_tpu/ops/curve_jax.py`` (``_canon_bias_np``, ``_fold_canonicalize``,
``_fold_pow_p58``, ``_compress_impl``, ``_sqrt_ratio_1v``,
``_decompress_impl``, ``_compress_consts`` and the wrappers
``ristretto_compress_device`` and ``ristretto_decompress_device``):
canonicalization, the 2^252-3 power chain of SQRT_RATIO_M1, sign selection
and the final canonical reduction, all as torch operations on ``(n, B)``
limb lanes of the same ``FieldOps`` the point kernels use. Every step is
the JAX version's, so the limbs of the canonical encodings, and of the
decoded coordinates, are identical to it. The device prover runs
:func:`_compress_impl` on its own lanes (``models/bp_device.py``); the two
wrappers take host points and 32-byte strings.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from . import ed25519 as ed
from .curve import edwards_engine
from .limbfold import FieldOps, int_to_limbs

_P25519 = (1 << 255) - 19


def _canon_bias_np(n: int) -> np.ndarray:
    """A multiple of p, redistributed so every limb is large enough to
    absorb the worst-case negative carries of a relaxed fold value
    (including the signed top-limb wrap through ONE = 2^(12n) mod p).

    16p reaches limb 21; rows above it are zeroed by the top-fold stage of
    :func:`_fold_canonicalize` before the bias is added, so they need no
    floor (carries into them stay non-negative)."""
    p = _P25519
    m = 16
    d = int_to_limbs(m * p, n).astype(np.int64)
    one = int_to_limbs((1 << (12 * n)) % p, n).astype(np.int64)
    floors = 8 + 4 * one
    floors[0] += 1 << 13
    floors[22:] = 0  # zeroed by the top-fold stage; carries in are >= 0
    top = min(n, 22)
    # greedy top-down redistribution: a unit at limb i+1 is 4096 at limb i
    for i in range(top - 1, 0, -1):
        need = floors[i - 1] - d[i - 1]
        if need > 0:
            take = (need + 4095) // 4096
            d[i] -= take
            d[i - 1] += take << 12
        assert d[i] >= floors[i], f"bias redistribution failed at limb {i}"
    assert d[0] >= floors[0]
    assert sum(int(v) << (12 * i) for i, v in enumerate(d)) % p == 0
    return d.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _top_fold_rows(n: int):
    """For each limb row j >= 22: the nonzero limbs (i, v) of 2^(12j) mod p."""
    out = []
    for j in range(22, n):
        ej = int_to_limbs((1 << (12 * j)) % _P25519, n)
        out.append((j, [(i, int(v)) for i, v in enumerate(ej) if v]))
    return out


def _fold_canonicalize(f: FieldOps, x: torch.Tensor) -> torch.Tensor:
    """Relaxed signed fold limbs -> canonical limbs in [0, 2^12), value < p.

    Signed carry passes restore limb bounds, a redistributed 16p bias makes
    every limb (and the value) non-negative, two 19*(v >> 255) folds bring
    the value under 2^255 + 19, and one branch-free conditional subtract
    lands on the canonical representative of GF(2^255 - 19).
    """
    n = f.n
    for _ in range(3):
        x = f.carry(x)
    # Top fold (n > 22 layouts): rows >= 22 carry weight 2^264+ and would
    # blow the |value| < ~2^266 budget the 19*(v>>255) folds below assume.
    # Replace each with its residue: 2^(12j) mod p spread over low limbs.
    if n > 22:
        for j, nz in _top_fold_rows(n):
            row = x[..., j, :]
            upd = torch.zeros_like(x)
            for i, v in nz:
                upd[..., i, :] += row * v
            x = x.clone()
            x[..., j, :] = 0
            x = x + upd
        x = f.carry(f.carry(x))
    bias = torch.from_numpy(_canon_bias_np(n)).to(x.device)[:, None]
    x = x + bias
    # full cascades: one parallel carry pass cannot propagate a ripple
    # through a run of all-ones limbs, so strict-limb form needs n passes
    for _ in range(n):
        x = f.carry(x)
    TI = 255 // 12  # 21: limb holding bit 255 (its bit 3)

    def hi_bits(v):
        h = v[..., TI, :] >> 3
        for j in range(TI + 1, n):
            h = h + (v[..., j, :] << (12 * (j - TI) - 3))
        return h

    def mod_2_255(v):
        out = v.clone()
        out[..., TI, :] &= 7
        out[..., TI + 1 :, :] = 0
        return out

    for _ in range(2):
        hi = hi_bits(x)
        x = mod_2_255(x)
        x[..., 0, :] += 19 * hi
        for _ in range(n):
            x = f.carry(x)
    # conditional subtract: v >= p  <=>  (v + 19) has bit 255 set
    w = x.clone()
    w[..., 0, :] += 19
    for _ in range(n):
        w = f.carry(w)
    ge = hi_bits(w) > 0  # (B,)
    return torch.where(ge.unsqueeze(-2), mod_2_255(w), x)


def _fold_eq(a_canon: torch.Tensor, b_canon: torch.Tensor) -> torch.Tensor:
    return torch.all(a_canon == b_canon, dim=-2)


def _fold_pow_p58(f: FieldOps, v: torch.Tensor) -> torch.Tensor:
    """v^((p-5)/8) = v^(2^252 - 3): the standard 25519 addition chain."""

    def sq_n(t, k):
        for _ in range(k):
            t = f.mul(t, t)
        return t

    t0 = f.mul(v, v)                      # 2
    t1 = sq_n(t0, 2)                      # 8
    t1 = f.mul(t1, v)                     # 9
    t0 = f.mul(t0, t1)                    # 11
    t0 = f.mul(t0, t0)                    # 22
    t0 = f.mul(t0, t1)                    # 31 = 2^5 - 1
    t1 = sq_n(t0, 5)
    t0 = f.mul(t1, t0)                    # 2^10 - 1
    t1 = sq_n(t0, 10)
    t1 = f.mul(t1, t0)                    # 2^20 - 1
    t2 = sq_n(t1, 20)
    t1 = f.mul(t2, t1)                    # 2^40 - 1
    t1 = sq_n(t1, 10)
    t0 = f.mul(t1, t0)                    # 2^50 - 1
    t1 = sq_n(t0, 50)
    t1 = f.mul(t1, t0)                    # 2^100 - 1
    t2 = sq_n(t1, 100)
    t1 = f.mul(t2, t1)                    # 2^200 - 1
    t1 = sq_n(t1, 50)
    t0 = f.mul(t1, t0)                    # 2^250 - 1
    t0 = sq_n(t0, 2)
    return f.mul(t0, v)                   # 2^252 - 3


def _where_lane(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select over (n, B) limbs; cond is (B,)."""
    return torch.where(cond.unsqueeze(-2), a, b)


def _compress_impl(consts: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(4, n, B) extended points -> canonical s limbs (n, B)."""
    f = FieldOps(edwards_engine().n, consts)
    sqrt_m1 = f.extra_const(1)
    invsqrt_amd = f.extra_const(2)
    one = f.extra_const(3)

    X, Y, Z, T = pts.unbind(-3)
    u1 = f.mul(f.add(Z, Y), f.sub(Z, Y))
    u2 = f.mul(X, Y)
    A = f.mul(u1, f.mul(u2, u2))
    # SQRT_RATIO_M1(1, A): r = A^3 * (A^7)^((p-5)/8)
    v3 = f.mul(f.mul(A, A), A)
    v7 = f.mul(f.mul(v3, v3), A)
    r = f.mul(v3, _fold_pow_p58(f, v7))
    check = f.mul(A, f.mul(r, r))
    check_c = _fold_canonicalize(f, check)
    zero = torch.zeros_like(check)
    neg_one_c = _fold_canonicalize(f, f.sub(zero, one.expand_as(check)))
    neg_sqm1_c = _fold_canonicalize(f, f.sub(zero, sqrt_m1.expand_as(check)))
    flipped = _fold_eq(check_c, neg_one_c) | _fold_eq(check_c, neg_sqm1_c)
    r = _where_lane(flipped, f.mul(r, sqrt_m1), r)
    r_c = _fold_canonicalize(f, r)
    r_neg_c = _fold_canonicalize(f, f.sub(torch.zeros_like(r), r_c))
    invsqrt = _where_lane((r_c[..., 0, :] & 1) == 1, r_neg_c, r_c)

    den1 = f.mul(invsqrt, u1)
    den2 = f.mul(invsqrt, u2)
    z_inv = f.mul(f.mul(den1, den2), T)
    tz_c = _fold_canonicalize(f, f.mul(T, z_inv))
    rotate = (tz_c[..., 0, :] & 1) == 1
    Xr = _where_lane(rotate, f.mul(Y, sqrt_m1), X)
    Yr = _where_lane(rotate, f.mul(X, sqrt_m1), Y)
    den_inv = _where_lane(rotate, f.mul(den1, invsqrt_amd), den2)
    xz_c = _fold_canonicalize(f, f.mul(Xr, z_inv))
    neg_x = (xz_c[..., 0, :] & 1) == 1
    Yf = _where_lane(neg_x, f.sub(torch.zeros_like(Yr), Yr), Yr)
    s = f.mul(den_inv, f.sub(Z, Yf))
    s_c = _fold_canonicalize(f, s)
    s_neg_c = _fold_canonicalize(f, f.sub(torch.zeros_like(s), s_c))
    return _where_lane((s_c[..., 0, :] & 1) == 1, s_neg_c, s_c)


def _sqrt_ratio_1v(f: FieldOps, A: torch.Tensor, sqrt_m1: torch.Tensor) -> tuple:
    """RFC 9496 SQRT_RATIO_M1 with u = 1: (was_square (B,), r (n, B))."""
    v3 = f.mul(f.mul(A, A), A)
    v7 = f.mul(f.mul(v3, v3), A)
    r = f.mul(v3, _fold_pow_p58(f, v7))
    check = f.mul(A, f.mul(r, r))
    check_c = _fold_canonicalize(f, check)
    one_b = f.extra_const(3).expand_as(check)
    zero = torch.zeros_like(check)
    one_c = _fold_canonicalize(f, one_b)
    neg_one_c = _fold_canonicalize(f, f.sub(zero, one_b))
    neg_sqm1_c = _fold_canonicalize(f, f.sub(zero, sqrt_m1.expand_as(check)))
    correct = _fold_eq(check_c, one_c)
    flipped = _fold_eq(check_c, neg_one_c)
    flipped_i = _fold_eq(check_c, neg_sqm1_c)
    r = _where_lane(flipped | flipped_i, f.mul(r, sqrt_m1), r)
    r_c = _fold_canonicalize(f, r)
    r_neg_c = _fold_canonicalize(f, f.sub(torch.zeros_like(r), r_c))
    r_abs = _where_lane((r_c[..., 0, :] & 1) == 1, r_neg_c, r_c)
    return correct | flipped, r_abs


def _decompress_impl(consts: torch.Tensor, s: torch.Tensor) -> tuple:
    """s: (n, B) canonical limbs -> (ok (B,), X, Y, T canonical (n, B))."""
    f = FieldOps(edwards_engine().n, consts)
    two_d = f.extra_const(0)
    sqrt_m1 = f.extra_const(1)

    ss = f.mul(s, s)
    one_b = f.extra_const(3).expand_as(ss)
    u1 = f.sub(one_b, ss)
    u2 = f.add(one_b, ss)
    u2_sqr = f.mul(u2, u2)
    # Only 2d is shipped as a constant, so work with the doubled quantity
    # 2v = -(2d * u1^2) - 2*u2^2 and take SQRT_RATIO_M1 of
    # 4*v*u2^2 = (2v)*(2*u2^2): the extra factor 4 is a square, so
    # was_square agrees and the root is invsqrt/2, recovered by doubling.
    u1_sq = f.mul(u1, u1)
    two_v = f.sub(torch.zeros_like(u1_sq), f.add(f.mul(two_d, u1_sq), f.add(u2_sqr, u2_sqr)))
    arg = f.mul(two_v, f.add(u2_sqr, u2_sqr))  # = 4 * v * u2^2
    was_square, invsqrt4 = _sqrt_ratio_1v(f, arg, sqrt_m1)
    # invsqrt = 2 * invsqrt4 up to sign; abs() is over the canonical
    # representative, so recompute it on the doubled value.
    invsqrt = f.add(invsqrt4, invsqrt4)
    iv_c = _fold_canonicalize(f, invsqrt)
    iv_neg = _fold_canonicalize(f, f.sub(torch.zeros_like(invsqrt), iv_c))
    invsqrt = _where_lane((iv_c[..., 0, :] & 1) == 1, iv_neg, iv_c)
    den_x = f.mul(invsqrt, u2)
    # den_y carries two_v = 2v, so y = u1 * den_y * (1/2) via the shipped
    # inv2 constant (no division).
    den_y = f.mul(f.mul(invsqrt, den_x), two_v)
    inv2 = f.extra_const(4)
    x_raw = f.mul(f.mul(f.add(s, s), den_x), one_b)
    x_c = _fold_canonicalize(f, x_raw)
    x_neg = _fold_canonicalize(f, f.sub(torch.zeros_like(x_raw), x_c))
    x = _where_lane((x_c[..., 0, :] & 1) == 1, x_neg, x_c)
    y = f.mul(f.mul(u1, den_y), inv2)
    t = f.mul(x, y)
    y_c = _fold_canonicalize(f, y)
    t_c = _fold_canonicalize(f, t)
    t_negative = (t_c[..., 0, :] & 1) == 1
    y_zero = torch.all(y_c == 0, dim=-2)
    ok = was_square & ~t_negative & ~y_zero
    return ok, x, y_c, t_c


@functools.lru_cache(maxsize=None)
def _compress_consts() -> np.ndarray:
    """Consts block for the encode and decode programs: TWO_D, SQRT_M1,
    INVSQRT_A_MINUS_D, 1, 1/2 as extra rows."""
    ctx = edwards_engine().ctx
    return ctx.consts_block(
        [
            ctx.encode_value(ed.TWO_D),
            ctx.encode_value(ed.SQRT_M1),
            ctx.encode_value(ed.INVSQRT_A_MINUS_D),
            ctx.encode_value(1),
            ctx.encode_value(pow(2, -1, ed.P)),
        ]
    )


def ristretto_compress_device(points: Sequence, *, device=None) -> List[bytes]:
    """Batched RFC 9496 ENCODE of host extended points: one upload, one
    :func:`_compress_impl`, one download. ``device`` defaults to the CUDA
    card; ``"cpu"`` runs the plain torch program."""
    device = resolve(device)
    eng = edwards_engine()
    enc = eng.encode_points(points)  # (B, 4, n)
    pts = torch.from_numpy(np.ascontiguousarray(np.transpose(enc, (1, 2, 0)))).to(device)
    consts = torch.from_numpy(_compress_consts()).to(device)
    s = _compress_impl(consts, pts).cpu().numpy()  # (n, B)
    return [int(v).to_bytes(32, "little") for v in eng.ctx.decode(s.T)]


def ristretto_decompress_device(encodings: Sequence[bytes], *, device=None) -> List[Optional[tuple]]:
    """Batched RFC 9496 DECODE: 32-byte strings -> extended host points
    ``(x, y, 1, t)``, or ``None`` for an invalid encoding, matching
    ``ed25519.decompress`` lane for lane. A wrong length, s >= p or an odd s
    is refused on the host; the rest in one :func:`_decompress_impl`."""
    device = resolve(device)
    ctx = edwards_engine().ctx
    vals, pre_ok = [], []
    for data in encodings:
        if len(data) != 32:
            pre_ok.append(False)
            vals.append(0)
            continue
        s = int.from_bytes(data, "little")
        pre_ok.append(s < ed.P and s % 2 == 0)
        vals.append(s % ed.P)
    s_arr = torch.from_numpy(np.ascontiguousarray(ctx.encode_ints(vals).T)).to(device)  # (n, B)
    consts = torch.from_numpy(_compress_consts()).to(device)
    ok, x, y, t = _decompress_impl(consts, s_arr)
    host = torch.cat([ok.to(torch.int32)[None], x, y, t]).cpu().numpy()  # one download
    n = x.shape[0]
    xs, ys, ts = (ctx.decode(host[1 + i * n : 1 + (i + 1) * n].T) for i in range(3))
    return [(int(xs[i]), int(ys[i]), 1, int(ts[i])) if pre_ok[i] and host[0, i] else None
            for i in range(len(vals))]
