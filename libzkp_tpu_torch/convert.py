"""Carry the JAX package's state into the port.

The system has no weights; its state is the Groth16 proving key (the
counterpart of weights: both packages prove with one key), the consts blocks
of the fold-field engines, the basis multiples tables, the Montgomery limb
tables of the NTT, the h pipeline and MiMC, and the STROBE transcript
snapshots the batched transcript resumes from. The JAX package
holds them as Python ints and tuples, numpy arrays (or arrays convertible
with ``np.asarray``) and bytes; these functions turn them into the port's
tensors and objects on a given device. Nothing here imports the JAX package:
callers hand over plain values, arrays and bytes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .models import groth16
from .ops import curve as curve_ops
from .ops.keccak_device import TranscriptDevice


def consts_block(arr, *, device) -> torch.Tensor:
    """A ``(rows, n)`` int32 consts block (``EdwardsEngine.consts_np``,
    ``_compress_consts()``, ``ScalarDeviceCtx.consts_np``) -> tensor."""
    a = np.asarray(arr)
    if a.dtype != np.int32 or a.ndim != 2:
        raise ValueError("consts blocks are 2-D int32 arrays")
    return torch.from_numpy(np.array(a)).to(device)


def proving_key(pk) -> groth16.ProvingKey:
    """A JAX ``groth16.ProvingKey`` (its ``vk`` included) -> the port's.

    Both hold points as Python ints and tuples (Jacobian G1 ``(X, Y, Z)``,
    G2 over Fq2 pairs), so the fields are copied as they are."""
    vk = pk.vk

    def g(p):
        return tuple(tuple(c) if isinstance(c, tuple) else int(c) for c in p)

    return groth16.ProvingKey(
        vk=groth16.VerifyingKey(
            alpha_g1=g(vk.alpha_g1), beta_g2=g(vk.beta_g2), gamma_g2=g(vk.gamma_g2),
            delta_g2=g(vk.delta_g2), gamma_abc_g1=[g(p) for p in vk.gamma_abc_g1],
        ),
        beta_g1=g(pk.beta_g1),
        delta_g1=g(pk.delta_g1),
        a_query=[g(p) for p in pk.a_query],
        b_g1_query=[g(p) for p in pk.b_g1_query],
        b_g2_query=[g(p) for p in pk.b_g2_query],
        h_query=[g(p) for p in pk.h_query],
        l_query=[g(p) for p in pk.l_query],
    )


def limb_table(arr, *, device) -> torch.Tensor:
    """A JAX ``(..., n)`` int32 table of 12-bit Montgomery limbs (the NTT's
    ``_twiddle_table``, the h pipeline's ``_h_tables``, MiMC's
    ``_mont_constants``) -> a tensor of the same limbs, the layout
    :mod:`.ops.limb` computes on."""
    a = np.asarray(arr)
    if a.dtype != np.int32 or a.ndim < 1:
        raise ValueError("limb tables are int32 arrays with the limbs last")
    return torch.from_numpy(np.array(a)).to(device)


def multiples_table(arr, K: int, *, device, curve: str = "ed25519") -> curve_ops.DeviceTable:
    """The JAX ``DeviceTable.table`` (``(Kp*256, C, n)`` int16) of a K-point
    basis of ``curve`` -> a port :class:`~.ops.curve.DeviceTable` holding the
    same rows.

    The table is taken as it is, not rebuilt."""
    eng = curve_ops.get_engine(curve)
    a = np.asarray(arr)
    if a.dtype != np.int16 or a.ndim != 3 or a.shape[1:] != (eng.coords, eng.n):
        raise ValueError(f"table must be (Kp*256, {eng.coords}, {eng.n}) int16")
    table = curve_ops.DeviceTable.__new__(curve_ops.DeviceTable)
    table.curve = curve
    table.K = K
    table.Kp = a.shape[0] // 256
    table.device = torch.device(device)
    table.consts = consts_block(eng.consts_np, device=device)
    table.table = torch.from_numpy(np.array(a)).to(device)
    return table


def sharded_table(arr, K: int, mesh, *, curve: str = "ed25519") -> curve_ops.ShardedTable:
    """The JAX ``DeviceTable.table`` of a K-point basis of ``curve`` -> the
    port's per-shard slices of it over ``mesh``, padded with identity rows as
    the JAX ``_msm_many_sharded_impl`` pads the table it shards."""
    rows = multiples_table(arr, K, device="cpu", curve=curve).table
    return curve_ops.ShardedTable(rows, K, mesh, curve=curve)


def transcript_state(snapshots: Sequence[bytes], *, device) -> TranscriptDevice:
    """203-byte ``Strobe128.state_bytes()`` snapshots, one per lane -> the
    port's batched transcript resumed at that position."""
    return TranscriptDevice.from_snapshots([bytes(s) for s in snapshots], device=device)


def strobe_words(words: Sequence, *, device) -> torch.Tensor:
    """The JAX ``StrobeDevice.state`` (50 uint32 half-lane arrays, low word
    first, any lane tiling) -> the port's ``(25, B)`` int64 lane state."""
    w = np.stack([np.asarray(x, dtype=np.uint32).reshape(-1) for x in words], axis=0)
    lanes = w[0::2].astype(np.uint64) | (w[1::2].astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(lanes.view(np.int64).copy()).to(device)
