"""MiMC-5 hash over BN254 Fr (the host golden tier).

Copy of the host part of the JAX package's ``libzkp_tpu/ops/mimc.py``,
mirroring the Rust reference (its ``src/backend/snark.rs:182-221``):

* 110 rounds of ``x <- (x + c_i)^5`` over BN254 Fr;
* round constants ``SHA256(b"libzkp_mimc_v1:" || u64_le(i))`` reduced from
  LE bytes mod r;
* 32-byte commitments are the canonical little-endian Fr serialization.

Two tiers, as in the JAX package:

* :func:`mimc_hash_native`, the host scalar path;
* :func:`mimc_hash_batch`, the batch on a device: 110 rounds of one add and
  three Montgomery products (:meth:`.limb.LimbContext.mont_pow5`) over
  (B, 22) limb tensors, on the ``mont_mul`` kernel on a CUDA device (its
  plain version on the CPU), split over the dp positions of a mesh. The
  limbs equal the JAX ``_mimc_batch_jit``'s.

The port keeps no memo of hashed values, and does not pad the batch (the
JAX package pads to a power of two, at least 16, to bound its compiles; an
eager batch compiles nothing).
"""

from __future__ import annotations

import functools
import hashlib
from typing import List

import numpy as np
import torch

from ..device import resolve
from ..parallel import mesh as meshmod
from .field import BN254_FR
from .limb import get_context, ints_to_limb_rows

MIMC_ROUNDS = 110


@functools.lru_cache(maxsize=1)
def mimc_constants() -> tuple:
    """Round constants as Python ints."""
    out = []
    for i in range(MIMC_ROUNDS):
        h = hashlib.sha256(b"libzkp_mimc_v1:" + i.to_bytes(8, "little")).digest()
        out.append(BN254_FR.from_le_bytes_mod(h))
    return tuple(out)


def mimc_hash_native(value: int) -> int:
    """Host-scalar MiMC-5 of ``value`` mod r."""
    p = BN254_FR.p
    x = value % p
    for c in mimc_constants():
        x = pow((x + c) % p, 5, p)
    return x


def fr_to_commitment(f: int) -> bytes:
    """Canonical 32-byte LE serialization of an Fr element."""
    return int(f).to_bytes(32, "little")


def fr_from_commitment(data: bytes):
    """Inverse of :func:`fr_to_commitment`; ``None`` if non-canonical."""
    if len(data) != 32:
        return None
    return BN254_FR.from_le_bytes_canonical(data)


# ---------------------------------------------------------------------------
# The batch on a device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _mont_constants() -> np.ndarray:
    """(110, n) round constants in Montgomery form (host numpy)."""
    ctx = get_context(BN254_FR.p, "bn254_fr")
    return ints_to_limb_rows([c * ctx.R % ctx.p for c in mimc_constants()], ctx.n)


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mont_constants()).to(device)


def _mimc_batch_impl(x_limbs: torch.Tensor, constants: torch.Tensor) -> torch.Tensor:
    """The rounds on Montgomery-domain limbs: x (B, n), constants (110, n)."""
    ctx = get_context(BN254_FR.p, "bn254_fr")
    for c in constants:
        x_limbs = ctx.mont_pow5(ctx.add(x_limbs, c))
    return x_limbs


def mimc_batch_device(x_canonical: torch.Tensor) -> torch.Tensor:
    """(B, n) canonical limbs -> (B, n) canonical limbs of the MiMC digests,
    on the tensor's device: 332 products (to_mont, 110 x 3, from_mont)."""
    ctx = get_context(BN254_FR.p, "bn254_fr")
    consts = _device_constants(x_canonical.device)
    return ctx.from_mont(_mimc_batch_impl(ctx.to_mont(x_canonical), consts))


def mimc_hash_batch(values, *, device=None, mesh=None) -> List[int]:
    """MiMC-5 of many values on a device; returns Python ints.

    ``device`` defaults to the CUDA card (``device="cpu"`` runs the plain
    versions). ``mesh`` defaults to the one the MSM seam would take
    (``parallel.mesh.mesh_for``); on a mesh of more than one position the
    batch is cut into dp contiguous blocks
    (:func:`.parallel.mesh.dp_sharding`), block d on the first device of dp
    row d, as the JAX package lays a batch over its ``dp`` axis."""
    dev = resolve(device)
    ctx = get_context(BN254_FR.p, "bn254_fr")
    vals = [int(v) for v in values]
    if not vals:
        return []
    if mesh is None:
        mesh = meshmod.mesh_for(dev)
    elif mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the entry device is {dev}")
    x = torch.from_numpy(ints_to_limb_rows([v % ctx.p for v in vals], ctx.n))
    if mesh is None:
        outs = [mimc_batch_device(x.to(dev))]
    else:
        outs = [mimc_batch_device(row[0]) for row in meshmod.dp_sharding(mesh).put(x) if row[0].shape[0]]
    return [v for out in outs for v in ctx.decode(out)]
