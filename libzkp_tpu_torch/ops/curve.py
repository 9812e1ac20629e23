"""The fixed-basis windowed MSM on torch tensors.

Port of the MSM half of the JAX package's ``libzkp_tpu/ops/curve_jax.py``:

* Points are ``(..., C, n, L)`` int32 tensors; the point engines live in
  :mod:`.edwards` (ed25519, re-exported here under the JAX module's names)
  and :mod:`.weierstrass` (BN254 G1 and G2, :func:`get_engine`).
* MSM = shared-multiples radix-256 windows: each basis point has a 256-entry
  multiples table (:class:`DeviceTable`, int16, built on the device by
  chaining the table-add kernel); scalar digits are the scalars' bytes. The
  MSM walks the 32 windows high to low.
* Two window loops on one device, as in the JAX package's v3 and v4 MSMs:
  ed25519 (the Bulletproofs path) runs :func:`msm_windows`, one window-sum
  and one Horner launch per window; BN254 G1/G2 (the Groth16 path) runs
  :func:`msm_windows4`, one ``window_sum4`` and one ``horner4`` launch per
  group of four windows (:mod:`.kernels`).
* The mesh-sharded MSM (:func:`msm_many_sharded`, the JAX function of that
  name) cuts the batch over a mesh's ``dp`` axis and the basis over its
  ``shard`` axis (:class:`ShardedTable`); each block runs the v1 window walk
  (:func:`msm_windows1`: a gather of table rows, ``tree_sum``, ``horner``
  per window) and the partial sums fold across ``shard``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel.collective import reduce_points
from ..parallel.mesh import Mesh, pad_to_multiple
from ..utils import tracing
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
        with tracing.span("table.build"):
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
    with tracing.span("msm.digits"):
        digits = _digits_from_scalars(scalar_vecs, table.K, table.Kp)
        Bp = _pad_batch(B)
        if Bp != B:
            digits = np.pad(digits, ((0, Bp - B), (0, 0), (0, 0)))
        digits = torch.from_numpy(digits).to(table.device)
    walk = msm_windows if table.curve == "ed25519" else msm_windows4
    with tracing.span("msm.walk"):  # the host waits for the card in .cpu()
        out = walk(table, _digits_to_windows(digits)).cpu().numpy()
    with tracing.span("msm.decode"):
        pts_np = np.transpose(out, (2, 0, 1))[:B]  # (B, C, n)
        return get_engine(table.curve).decode_points(pts_np)


# ---------------------------------------------------------------------------
# Mesh-sharded variant: batch over 'dp', basis over 'shard'
# ---------------------------------------------------------------------------


class ShardedTable:
    """A basis's multiples table cut over a mesh's ``shard`` axis.

    ``rows`` is a ``(Kp*256, C, n)`` int16 table of a K-point basis (a
    :class:`DeviceTable`'s ``table``). As in the JAX
    ``_msm_many_sharded_impl``, the basis is padded with identity rows to
    ``k_local * shard`` points, ``k_local = ceil(ceil(Kp / shard) / kc) * kc``
    with ``kc = min(K_CHUNK, Kp)``, and shard s's slice (points
    ``s*k_local .. (s+1)*k_local - 1``) and the curve's consts block are put
    on every device of mesh column s (``slices[d][s]``, ``consts[d][s]``).
    """

    def __init__(self, rows: torch.Tensor, K: int, mesh: Mesh, *, curve: str):
        if mesh.size <= 1:
            raise ValueError("a sharded table needs a mesh of more than one position")
        eng = get_engine(curve)
        C, n = eng.coords, eng.n
        if rows.dtype != torch.int16 or rows.dim() != 3 or tuple(rows.shape[1:]) != (C, n):
            raise ValueError(f"rows must be (Kp*256, {C}, {n}) int16")
        shard = mesh.shape["shard"]
        Kp = rows.shape[0] // 256
        kc = min(K_CHUNK, Kp)
        self.curve, self.K, self.mesh = curve, K, mesh
        self.k_local = ((Kp + shard - 1) // shard + kc - 1) // kc * kc
        self.Kp = self.k_local * shard
        if self.Kp != Kp:
            ident = torch.from_numpy(eng.identity_np().astype(np.int16)).to(rows.device)
            rows = torch.cat([rows, ident.expand((self.Kp - Kp) * 256, C, n)])
        span = self.k_local * 256
        consts = torch.from_numpy(eng.consts_np)
        self.slices = tuple(tuple(rows[s * span : (s + 1) * span].to(dev) for s, dev in enumerate(row))
                            for row in mesh.devices)
        self.consts = tuple(tuple(consts.to(dev) for dev in row) for row in mesh.devices)


def msm_windows1(consts: torch.Tensor, rows: torch.Tensor, digits: torch.Tensor, *,
                 curve: str) -> torch.Tensor:
    """v1 MSM on one block (the body of the JAX ``_msm_jit``): ``rows`` is
    the block's (k*256, C, n) int16 table slice, ``digits`` its (b, k, 32)
    uint8 scalar bytes, both on the block's device. Per window, high first:
    gather each lane's rows (lane-major, as ``tree_sum`` reads them),
    ``tree_sum``, ``horner``. Returns (C, n, b)."""
    b, k = digits.shape[:2]
    koff = torch.arange(k, device=digits.device, dtype=torch.int64) * 256
    acc = get_engine(curve).identity(b, digits.device)
    for w in range(NWIN):
        pts = rows[digits[:, :, NWIN - 1 - w].to(torch.int64) + koff]  # (b, k, C, n)
        acc = kernels.horner(consts, acc, kernels.tree_sum(consts, pts, curve=curve), curve=curve)
    return acc


def msm_many_sharded(table, scalar_vecs: Sequence[Sequence[int]], mesh: Mesh):
    """Batch of independent MSMs over the (dp, shard) ``mesh`` -> host
    points. ``table`` is a :class:`ShardedTable` over ``mesh``, or a
    :class:`DeviceTable` (then cut here). With one mesh position this is
    :func:`msm_many`, as in the JAX package."""
    if mesh.size <= 1:
        if not isinstance(table, DeviceTable):
            raise ValueError("a one-position mesh runs msm_many on a DeviceTable")
        return msm_many(table, scalar_vecs)
    if isinstance(table, DeviceTable):
        table = ShardedTable(table.table, table.K, mesh, curve=table.curve)
    elif table.mesh != mesh:
        raise ValueError("the table is sharded over another mesh")
    return _msm_many_sharded_impl(table, scalar_vecs)


def _msm_many_sharded_impl(table: ShardedTable, scalar_vecs: Sequence[Sequence[int]]):
    """Rows split over ``dp`` (``Bp = pad_to_multiple(_pad_batch(max(B, dp)),
    dp)``, ``b_local = Bp // dp``), the basis over ``shard``; block (d, s)
    runs :func:`msm_windows1` on its device, the partial sums of dp group d
    fold on its first device (:func:`reduce_points` with ``pair_add``), and
    the groups' lanes are concatenated in order."""
    dp = table.mesh.shape["dp"]
    B = len(scalar_vecs)
    if B == 0:
        return []
    digits = _digits_from_scalars(scalar_vecs, table.K, table.Kp)
    Bp = pad_to_multiple(_pad_batch(max(B, dp)), dp)
    if Bp != B:
        digits = np.pad(digits, ((0, Bp - B), (0, 0), (0, 0)))
    digits = torch.from_numpy(digits)
    b_local, k = Bp // dp, table.k_local
    curve = table.curve
    outs = []
    for d, row in enumerate(table.mesh.devices):
        parts = [
            msm_windows1(table.consts[d][s], table.slices[d][s],
                         digits[d * b_local : (d + 1) * b_local, s * k : (s + 1) * k].to(dev),
                         curve=curve)
            for s, dev in enumerate(row)
        ]
        consts = table.consts[d][0]
        outs.append(reduce_points(lambda a, b: kernels.pair_add(consts, a, b, curve=curve), parts))
    out = torch.cat([o.cpu() for o in outs], dim=-1).numpy()
    return get_engine(curve).decode_points(np.transpose(out, (2, 0, 1))[:B])
