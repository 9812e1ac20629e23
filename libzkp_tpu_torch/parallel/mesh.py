"""Device meshes for the mesh-sharded MSM.

Port of the mesh half of the JAX package's ``libzkp_tpu/parallel/mesh.py``: a
grid of devices with a ``dp`` (batch) axis and a ``shard`` (basis) axis.
Where JAX lays a ``jax.sharding.Mesh`` over its devices and lets
``shard_map`` place the blocks, here a :class:`Mesh` is the ``(dp, shard)``
grid of ``torch.device``s itself, and the sharded MSM
(:func:`libzkp_tpu_torch.ops.curve.msm_many_sharded`) puts each block's work
on its device.

A mesh may name one device at several positions: that is how the tests (on
the CPU) and a one-card run stand in for a pod, as the JAX package's tests use
8 virtual CPU devices. Such a mesh checks the sharding, the per-block work and
the cross-shard fold; it measures no interconnect.

The seam (:mod:`libzkp_tpu_torch.ops.msm_device`) and the MiMC batch
(:func:`libzkp_tpu_torch.ops.mimc.mimc_hash_batch`) take the mesh that
:func:`set_mesh` names, or else the default mesh over every CUDA device when
:func:`use_mesh` holds (:func:`mesh_for`). There is no environment knob.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """A ``(dp, shard)`` grid of devices: ``devices[d][s]`` runs block
    ``(d, s)``; :attr:`shape` names the axes. Hashable, so it can key a
    cache."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "shard": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def device_type(self) -> str:
        return self.devices[0][0].type


def get_mesh(dp: Optional[int] = None, shard: int = 1,
             devices: Optional[Sequence] = None) -> Mesh:
    """A ``(dp, shard)`` mesh over ``devices`` (default: every visible CUDA
    device), taking the first ``dp * shard`` of them in order; ``dp``
    defaults to ``len(devices) // shard``. Raises without a CUDA device when
    none are named, when the mesh needs more devices than are given, and for
    a list that mixes device types."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "get_mesh defaults to the CUDA devices and torch.cuda.is_available() is "
                "False; pass devices=[torch.device('cpu')] * k for a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh takes devices of one type, got {sorted({d.type for d in devs})}")
    if dp is None:
        dp = len(devs) // shard
    if dp < 1 or shard < 1 or dp * shard > len(devs):
        raise ValueError(f"mesh {dp}x{shard} needs {dp * shard} devices, {len(devs)} given")
    return Mesh(tuple(tuple(devs[d * shard : (d + 1) * shard]) for d in range(dp)))


def num_dp(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or get_mesh()
    return mesh.shape["dp"]


def mesh_for(dev: torch.device) -> Optional[Mesh]:
    """The mesh a batch on entry device ``dev`` spreads over, or None: the
    mesh :func:`set_mesh` named, else the default mesh when :func:`use_mesh`
    holds and ``dev`` is a CUDA device; None for a mesh of one position.
    Raises for a mesh on another device type than ``dev``."""
    mesh = current_mesh()
    if mesh is None and dev.type == "cuda" and use_mesh():
        mesh = get_mesh()
    if mesh is None or mesh.size <= 1:
        return None
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the entry device is {dev}")
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def use_mesh() -> bool:
    """Should the MSM seam shard over the default mesh? Yes when more than
    one CUDA device is visible."""
    return torch.cuda.is_available() and torch.cuda.device_count() > 1


_MESH: list = [None]


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Name the mesh the MSM seam runs on (``None``: back to the default)."""
    _MESH[0] = mesh


def current_mesh() -> Optional[Mesh]:
    """The mesh :func:`set_mesh` named, or None."""
    return _MESH[0]
