"""The fixed-basis windowed MSM on torch tensors.

Port of the MSM half of the JAX package's ``libzkp_tpu/ops/curve_jax.py``:

* Points are ``(..., C, n, L)`` int32 tensors; the point engines live in
  :mod:`.edwards` (ed25519, re-exported here under the JAX module's names)
  and :mod:`.weierstrass` (BN254 G1 and G2, :func:`get_engine`).
* MSM = shared-multiples radix-256 windows: each basis point has a 256-entry
  multiples table (:class:`DeviceTable`, int16, built on the device by
  chaining the table-add kernel); scalar digits are the scalars' bytes. The
  MSM walks the 32 windows high to low.
* Two window loops, as in the JAX package's v3 and v4 MSMs: ed25519 (the
  Bulletproofs path) runs :func:`msm_windows`, one window-sum and one Horner
  launch per window; BN254 G1/G2 (the Groth16 path) runs
  :func:`msm_windows4`, one ``window_sum4`` and one ``horner4`` launch per
  group of four windows (:mod:`.kernels`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import kernels
from .edwards import EdwardsEngine, _tree_reduce, edwards_engine  # noqa: F401  (re-exported)
from .weierstrass import get_engine

SCALAR_BYTES = 32
NWIN = SCALAR_BYTES
K_CHUNK = 32  # basis padding granule (the JAX kernels' K chunk)
WIN_GROUP = kernels.WIN_GROUP


def _pad_batch(B: int) -> int:
    """Lane buckets: powers of two from 8 to 1024, then multiples of 1024."""
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):
        if B <= b:
            return b
    return ((B + 1023) // 1024) * 1024


class DeviceTable:
    """A basis's radix-256 multiples table on a device.

    ``table`` is ``(Kp*256, C, n)`` int16: row ``k*256 + d`` holds ``d`` times
    basis point ``k`` (relaxed limbs stay within int16: below 2^13 for
    ed25519, in [-7643, 11737] for BN254, ``csrc/fold_curves.cuh``). The basis
    (``base_np``, ``(K, C, n)`` limbs from the engine's ``encode_points``) is
    padded with identity points to a multiple of the K chunk. The table is
    built where it lives, by 255 chained table-add launches (the plain
    version of that kernel on the CPU), as the JAX ``_table_build_jit``
    chains its table-add kernel.
    """

    def __init__(self, base_np: np.ndarray, *, device, curve: str = "ed25519"):
        eng = get_engine(curve)
        C, n = eng.coords, eng.n
        self.curve = curve
        self.K = base_np.shape[0]
        kc = min(K_CHUNK, _pad_batch(self.K))
        self.Kp = ((self.K + kc - 1) // kc) * kc
        self.device = torch.device(device)
        self.consts = torch.from_numpy(eng.consts_np).to(self.device)
        if self.Kp != self.K:
            pad = np.broadcast_to(eng.identity_np()[None], (self.Kp - self.K, C, n))
            base_np = np.concatenate([base_np, pad], axis=0)
        baseT = torch.from_numpy(np.ascontiguousarray(np.transpose(base_np, (1, 2, 0))))
        baseT = baseT.to(self.device)  # (C, n, Kp)
        acc = eng.identity(self.Kp, self.device)
        rows = [acc]
        for _ in range(255):
            acc = kernels.pair_add(self.consts, acc, baseT, curve=curve)
            rows.append(acc)
        table = torch.stack(rows, dim=0)  # (256, C, n, Kp)
        self.table = (
            table.permute(3, 0, 1, 2).reshape(self.Kp * 256, C, n).to(torch.int16).contiguous()
        )


def _digits_from_scalars(scalar_vecs, K: int, Kp: int) -> np.ndarray:
    """(B, K) scalars -> (B, Kp, 32) uint8 scalar bytes (window digits).

    Padded basis columns get digit 0 (-> identity table rows)."""
    buf = b"".join(
        [int(s).to_bytes(SCALAR_BYTES, "little") for vec in scalar_vecs for s in vec]
    )
    arr = np.frombuffer(bytearray(buf), dtype=np.uint8).reshape(len(scalar_vecs), K, SCALAR_BYTES)
    if Kp != K:
        arr = np.pad(arr, ((0, 0), (0, Kp - K), (0, 0)))
    return arr


def _digits_to_windows(digits: torch.Tensor) -> torch.Tensor:
    """(B, Kp, 32) uint8 tensor -> (NWIN, Kp, B) int32, high window first."""
    return torch.flip(digits.permute(2, 1, 0), dims=(0,)).to(torch.int32).contiguous()


def msm_windows(table: DeviceTable, dw: torch.Tensor) -> torch.Tensor:
    """v3 MSM (ed25519): batched MSM from digit windows ``(NWIN, Kp, B)``
    (high first) -> (4, n, B). One window-sum and one Horner launch per
    window."""
    eng = edwards_engine()
    acc = eng.identity(dw.shape[-1], dw.device)
    for w in range(dw.shape[0]):
        acc = kernels.horner(table.consts, acc,
                             kernels.window_sum(table.consts, table.table, dw[w]))
    return acc


def msm_windows4(table: DeviceTable, dw: torch.Tensor) -> torch.Tensor:
    """v4 MSM (BN254): batched MSM from digit windows ``(NWIN, Kp, B)``
    (high first) -> (C, n, B), the JAX ``_msm_jit_v4`` as a loop over the 8
    groups of WIN_GROUP windows, high group first: per group one
    ``window_sum4`` launch, (C, n, 4B), and one ``horner4`` launch."""
    eng = get_engine(table.curve)
    acc = eng.identity(dw.shape[-1], dw.device)
    for g in range(0, dw.shape[0], WIN_GROUP):
        wsums = kernels.window_sum4(table.consts, table.table, dw[g : g + WIN_GROUP],
                                    curve=table.curve)
        acc = kernels.horner4(table.consts, acc, wsums, curve=table.curve)
    return acc


def msm_many(table: DeviceTable, scalar_vecs: Sequence[Sequence[int]]):
    """Batch of independent MSMs over one fixed basis -> host points
    (extended Edwards for ed25519, Jacobian for BN254 G1/G2)."""
    B = len(scalar_vecs)
    if B == 0:
        return []
    digits = _digits_from_scalars(scalar_vecs, table.K, table.Kp)
    Bp = _pad_batch(B)
    if Bp != B:
        digits = np.pad(digits, ((0, Bp - B), (0, 0), (0, 0)))
    dw = _digits_to_windows(torch.from_numpy(digits).to(table.device))
    walk = msm_windows if table.curve == "ed25519" else msm_windows4
    out = walk(table, dw).cpu().numpy()
    pts_np = np.transpose(out, (2, 0, 1))[:B]  # (B, C, n)
    return get_engine(table.curve).decode_points(pts_np)
