"""Complete projective short-Weierstrass arithmetic on torch tensors (BN254).

The ``WeierstrassEngine`` half of the JAX package's
``libzkp_tpu/ops/curve_jax.py``: y^2 = x^3 + b with a = 0, by the complete
Renes–Costello–Batina formulas (2015, algorithm 7), on 12-bit fold-field
limbs (:mod:`.limbfold`). Points are ``(..., C, n, L)`` int32 tensors with
C = 3 * rows: projective (X, Y, Z), each coordinate ``rows`` field rows —
one over Fq for G1, two over Fq2 = Fq[u]/(u^2+1) for G2 (c0, c1).

* G1: b3 = 3b = 9, a small multiply; consts block ``(n + 3, n)``.
* G2: b3 = 3 * 3/(9+u), a full Fq2 constant in two extra consts rows;
  consts block ``(n + 5, n)``.

The formulas issue their independent field products as one stacked product
per round (two rounds of products per ``padd``, plus the b3 products); every
product sees the operands the JAX formula gives it, in the JAX order of
additions and carries, so limbs are identical to its ``padd``. ``pdouble``
is ``padd(p, p)``. :func:`get_engine` names the three curves of the port.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from . import bn254 as bn
from .edwards import edwards_engine
from .limbfold import FieldOps, get_fold_ctx

CURVES = ("ed25519", "bn254_g1", "bn254_g2")


def _fq2_mul(f: FieldOps, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stacked Fq2 products: ``a``, ``b`` are ``(..., 2k, n, L)``, k elements
    of two rows (c0, c1) each. Karatsuba as the JAX ``_Fq2.mul``:
    m0 = a0 b0, m1 = a1 b1, t = (a0 + a1)(b0 + b1), c0 = m0 - m1,
    c1 = (t - m0) - m1, each sum and difference carried once."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0::2, :, :], a[..., 1::2, :, :]
    b0, b1 = b[..., 0::2, :, :], b[..., 1::2, :, :]
    k = a0.shape[-3]
    sa, sb = f.carry(torch.cat([a0 + a1, b0 + b1], -3)).split(k, -3)
    m0, m1, t = f.mul(torch.cat([a0, a1, sa], -3), torch.cat([b0, b1, sb], -3)).split(k, -3)
    c0, d = f.carry(torch.cat([m0 - m1, t - m0], -3)).split(k, -3)
    c1 = f.carry(d - m1)
    return torch.stack([c0, c1], -3).flatten(-4, -3)


class WeierstrassEngine:
    """Complete projective y^2 = x^3 + b, a = 0, over Fq (rows = 1) or Fq2
    (rows = 2): ``(..., 3 * rows, n, L)``."""

    def __init__(self, curve: str, p: int, rows: int, b3_small=None, b3_rows=()):
        self.curve = curve
        self.ctx = get_fold_ctx(p)
        self.n = self.ctx.n
        self.rows = rows
        self.coords = 3 * rows
        self.b3_small = b3_small
        self.consts_np = self.ctx.consts_block(list(b3_rows))

    def _mul(self, f: FieldOps, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Stacked field products of this curve's coordinate field."""
        return f.mul(a, b) if self.rows == 1 else _fq2_mul(f, a, b)

    def _mul_b3(self, f: FieldOps, x: torch.Tensor) -> torch.Tensor:
        """b3 * x for stacked elements x."""
        if self.b3_small is not None:
            return f.smul(x, self.b3_small)
        b3 = torch.stack([f.extra_const(0), f.extra_const(1)], 0)  # (2, n, 1)
        return _fq2_mul(f, x, b3.repeat(x.shape[-3] // 2, 1, 1))

    def padd(self, consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """RCB 2015 algorithm 7 (complete, a = 0)."""
        f = FieldOps(self.n, consts)
        r = self.rows
        X1, Y1, Z1 = p.split(r, -3)
        X2, Y2, Z2 = q.split(r, -3)
        # X1+Y1, Y1+Z1, X1+Z1 (and for q), then t0 = X1X2, t1 = Y1Y2,
        # t2 = Z1Z2, t3, t4 and X3 in one stacked product
        s1 = f.carry(torch.cat([X1 + Y1, Y1 + Z1, X1 + Z1], -3))
        s2 = f.carry(torch.cat([X2 + Y2, Y2 + Z2, X2 + Z2], -3))
        t0, t1, t2, t3, t4, X3 = self._mul(
            f, torch.cat([X1, Y1, Z1, s1], -3), torch.cat([X2, Y2, Z2, s2], -3)
        ).split(r, -3)
        u = f.carry(torch.cat([t0 + t1, t1 + t2, t0 + t2], -3))
        t3, t4, Y3 = f.carry(torch.cat([t3, t4, X3], -3) - u).split(r, -3)
        X3 = f.carry(t0 + t0 + t0)
        t2, Y3 = self._mul_b3(f, torch.cat([t2, Y3], -3)).split(r, -3)
        Z3, t1 = f.carry(torch.cat([t1 + t2, t1 - t2], -3)).split(r, -3)
        m = self._mul(f, torch.cat([t3, t4, t1, Y3, Z3, X3], -3),
                      torch.cat([t1, Y3, Z3, X3, t4, t3], -3))
        p1, p2, p3, p4, p5, p6 = m.split(r, -3)
        return f.carry(torch.cat([p1 - p2, p3 + p4, p5 + p6], -3))

    def pdouble(self, consts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return self.padd(consts, p, p)

    def identity_np(self) -> np.ndarray:
        out = np.zeros((self.coords, self.n), dtype=np.int32)
        out[self.rows, 0] = 1  # (0 : 1 : 0), Y = 1 (c0)
        return out

    def identity(self, B: int, device) -> torch.Tensor:
        """(C, n, B) identity lanes."""
        ident = torch.from_numpy(self.identity_np()).to(device)
        return ident[..., None].expand(self.coords, self.n, B).contiguous()

    # -- host codecs: host Jacobian points <-> projective limbs -------------
    def encode_points(self, points) -> np.ndarray:
        """Host Jacobian points -> (K, C, n) canonical limbs."""
        return self._encode_g1(points) if self.rows == 1 else self._encode_g2(points)

    def decode_points(self, arr_np) -> list:
        """(B, C, n) relaxed limbs -> host Jacobian points."""
        return self._decode_g1(arr_np) if self.rows == 1 else self._decode_g2(arr_np)

    def _encode_g1(self, points) -> np.ndarray:
        P = self.ctx.p
        flat = []
        for X, Y, Z in points:
            if Z % P == 0:
                flat += [0, 1, 0]
            else:
                flat += [X * Z % P, Y % P, Z * Z % P * Z % P]
        return self.ctx.encode_ints(flat).reshape(len(points), 3, self.n)

    def _decode_g1(self, arr_np) -> List[Tuple[int, int, int]]:
        vals = self.ctx.decode(arr_np)
        P = self.ctx.p
        out = []
        for i in range(len(vals) // 3):
            X, Y, Z = vals[3 * i : 3 * i + 3]
            if Z == 0:
                out.append((1, 1, 0))
            else:
                out.append((X * Z % P, Y * Z % P * Z % P, Z))
        return out

    def _encode_g2(self, points) -> np.ndarray:
        P = self.ctx.p
        flat = []
        for X, Y, Z in points:
            if Z[0] % P == 0 and Z[1] % P == 0:
                flat += [0, 0, 1, 0, 0, 0]
            else:
                z2 = bn.fq2_sq(Z)
                xp = bn.fq2_mul(X, Z)
                zp = bn.fq2_mul(z2, Z)
                flat += [xp[0], xp[1], Y[0] % P, Y[1] % P, zp[0], zp[1]]
        return self.ctx.encode_ints(flat).reshape(len(points), 6, self.n)

    def _decode_g2(self, arr_np):
        vals = self.ctx.decode(arr_np)
        out = []
        for i in range(len(vals) // 6):
            x = (vals[6 * i], vals[6 * i + 1])
            y = (vals[6 * i + 2], vals[6 * i + 3])
            z = (vals[6 * i + 4], vals[6 * i + 5])
            if z == (0, 0):
                out.append((bn.FQ2_ONE, bn.FQ2_ONE, (0, 0)))
            else:
                out.append((bn.fq2_mul(x, z), bn.fq2_mul(y, bn.fq2_sq(z)), z))
        return out


@functools.lru_cache(maxsize=None)
def bn254_g1_engine() -> WeierstrassEngine:
    return WeierstrassEngine("bn254_g1", bn.P, rows=1, b3_small=9)


@functools.lru_cache(maxsize=None)
def bn254_g2_engine() -> WeierstrassEngine:
    b_twist = bn.fq2_mul_scalar(bn.fq2_inv((9, 1)), 3)
    b3 = bn.fq2_mul_scalar(b_twist, 3)
    ctx = get_fold_ctx(bn.P)
    return WeierstrassEngine(
        "bn254_g2", bn.P, rows=2, b3_small=None,
        b3_rows=(ctx.encode_value(b3[0]), ctx.encode_value(b3[1])),
    )


def get_engine(curve: str):
    """The point engine of ``curve`` (one of :data:`CURVES`)."""
    if curve == "ed25519":
        return edwards_engine()
    if curve == "bn254_g1":
        return bn254_g1_engine()
    if curve == "bn254_g2":
        return bn254_g2_engine()
    raise ValueError(f"unknown curve {curve}")
