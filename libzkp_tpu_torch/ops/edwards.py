"""Extended twisted Edwards point arithmetic on torch tensors.

The ``EdwardsEngine`` half of the JAX package's
``libzkp_tpu/ops/curve_jax.py``: points are ``(..., 4, n, L)`` int32
tensors — extended coordinates (X, Y, Z, T) × 12-bit fold-field limbs
(:mod:`.limbfold`) × batch lanes, with the complete unified a=-1 addition law
(branch-free). The plain versions of the kernels (:mod:`.kernels`) and the
MSM driver (:mod:`.curve`) both build on it.

The point formulas issue their independent field products as one stacked
product each (four rounds of products per ``padd`` instead of nine); every
product sees the operands the JAX formula gives it, so limbs stay
bit-identical to ``EdwardsEngine.padd`` / ``pdouble``.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from . import ed25519 as ed
from .limbfold import FieldOps, get_fold_ctx


class EdwardsEngine:
    """Extended twisted Edwards a=-1 (Curve25519/Ristretto): (..., 4, n, L)."""

    coords = 4

    def __init__(self):
        self.ctx = get_fold_ctx(ed.P)
        self.n = self.ctx.n
        self.consts_np = self.ctx.consts_block([self.ctx.encode_value(ed.TWO_D)])

    def padd(self, consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """add-2008-hwcd-3 unified (complete for Ristretto points)."""
        f = FieldOps(self.n, consts)
        X1, Y1, Z1, T1 = p.unbind(-3)
        X2, Y2, Z2, T2 = q.unbind(-3)
        # A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2), T1*T2, Z1*Z2
        lhs = torch.cat([f.carry(torch.stack([Y1 - X1, Y1 + X1], -3)),
                         torch.stack([T1, Z1], -3)], -3)
        rhs = torch.cat([f.carry(torch.stack([Y2 - X2, Y2 + X2], -3)),
                         torch.stack([T2, Z2], -3)], -3)
        A, B, TT, zz = f.mul(lhs, rhs).unbind(-3)
        C = f.mul(TT, f.extra_const(0))
        D = f.carry(zz + zz)
        E, F_, G, H = f.carry(torch.stack([B - A, D - C, D + C, B + A], -3)).unbind(-3)
        return f.mul(torch.stack([E, G, F_, E], -3), torch.stack([F_, H, G, H], -3))

    def pdouble(self, consts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """dbl-2008-hwcd (8 muls, identity-safe)."""
        f = FieldOps(self.n, consts)
        X1, Y1, Z1, _ = p.unbind(-3)
        xy = f.carry(X1 + Y1)
        sq = torch.stack([X1, Y1, Z1, xy], -3)
        A, B, zz, xy2 = f.mul(sq, sq).unbind(-3)
        C, H, G = f.carry(torch.stack([zz + zz, A + B, A - B], -3)).unbind(-3)
        E, F_ = f.carry(torch.stack([H - xy2, C + G], -3)).unbind(-3)
        return f.mul(torch.stack([E, G, F_, E], -3), torch.stack([F_, H, G, H], -3))

    def identity_np(self) -> np.ndarray:
        out = np.zeros((4, self.n), dtype=np.int32)
        out[1, 0] = 1
        out[2, 0] = 1
        return out

    def identity(self, B: int, device) -> torch.Tensor:
        """(4, n, B) identity lanes."""
        ident = torch.from_numpy(self.identity_np()).to(device)
        return ident[..., None].expand(4, self.n, B).contiguous()

    def encode_points(self, points) -> np.ndarray:
        """Host extended points -> (K, 4, n) canonical limbs."""
        flat = [c for pt in points for c in pt]
        return self.ctx.encode_ints(flat).reshape(len(points), 4, self.n)

    def decode_points(self, arr_np) -> List[Tuple[int, int, int, int]]:
        """(B, 4, n) -> host extended points."""
        vals = self.ctx.decode(arr_np)
        return [tuple(vals[4 * i : 4 * i + 4]) for i in range(len(vals) // 4)]


@functools.lru_cache(maxsize=None)
def edwards_engine() -> EdwardsEngine:
    return EdwardsEngine()


def _tree_reduce(add_fn, v: torch.Tensor) -> torch.Tensor:
    """Halving reduction over axis 0 of (K, C, n, L), pairing (i, i+half)
    exactly as the JAX version does, so the limbs agree with it."""
    K = v.shape[0]
    while K > 1:
        half = K // 2
        s = add_fn(v[:half], v[half : 2 * half])
        if K % 2:
            s = torch.cat([s, v[-1:]], dim=0)
        v = s
        K = (K + 1) // 2
    return v[0]
