"""Device meshes, their placements and the multi-process bootstrap.

Port of the JAX package's ``libzkp_tpu/parallel/mesh.py``: a grid of devices
with a ``dp`` (batch) axis and a ``shard`` (intra-proof) axis. Where JAX lays
a ``jax.sharding.Mesh`` over its devices and lets ``shard_map`` place the
blocks, here a :class:`Mesh` is the ``(dp, shard)`` grid of
``torch.device``s itself, and a sharded value is a ``[dp][shard]`` tuple of
tensors, each on its position's device (:class:`Sharding`: :func:`dp_sharding`,
:func:`replicated`). The collectives
(:mod:`libzkp_tpu_torch.parallel.collective`), the sharded MSM
(:func:`libzkp_tpu_torch.ops.curve.msm_many_sharded`), the four-step NTT
(:func:`libzkp_tpu_torch.ops.ntt.ntt_sharded`) and the dp split of
``coset_lde_batch`` put each block's work on its device.

Across processes (:func:`init_distributed`), only ``dp`` spans them, as the
JAX package keeps ``shard`` inside one host's interconnect and lets ``dp``
ride the network: each process drives a grid of ``dp_local x shard`` of its
own devices, ``dp``'s size is ``processes * dp_local``, and local row ``d``
is global row ``process_index * dp_local + d``. A dp-split array is held as
each process's own slice (the global array is the slices in process order,
as JAX's host-local arrays are), so a placement splits only the process's
slice. The consumers (MSM, MiMC, NTT, LDE) run on the process's own grid;
``psum`` and ``all_gather`` over ``dp`` reach the other processes.

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

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A ``(dp, shard)`` grid of devices: ``devices[d][s]`` runs block
    ``(d, s)``; :attr:`shape` names the axes of this process's grid.
    ``processes`` is the number of processes whose grids ``dp`` spans
    (1 without :func:`init_distributed`), ``process_index`` this one's
    place among them. Hashable, so it can key a cache."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    processes: int = 1
    process_index: int = 0

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
    a list that mixes device types. Once :func:`init_distributed` has
    brought a process group up, ``dp`` counts this process's rows and the
    mesh's ``dp`` axis spans every process of the group."""
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
    grid = tuple(tuple(devs[d * shard : (d + 1) * shard]) for d in range(dp))
    if dist.is_available() and dist.is_initialized():
        return Mesh(grid, dist.get_world_size(), dist.get_rank())
    return Mesh(grid)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Bring up the ``torch.distributed`` process group that a multi-host
    mesh's ``dp`` axis spans; call it before the first :func:`get_mesh`.

    Each value comes from its argument, else from the JAX package's
    environment names (``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), else
    from torchrun's (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). A bare ``host:port`` address becomes ``tcp://host:port``; an
    address with a scheme (``file://...``) is passed on as it is. The
    backend is ``nccl`` when CUDA is available, else ``gloo``.

    Returns False when no address is configured (a single host: nothing to
    do) and True once the group is up; a second call returns True. A failed
    init raises, and so does an address without a process count or index.
    There is no auto-discovery: the JAX package's Cloud TPU pod discovery
    (``TPU_WORKER_HOSTNAMES``) has no counterpart here."""
    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if addr is None:
        return False

    def value(arg, *names) -> int:
        if arg is not None:
            return int(arg)
        for name in names:
            if env.get(name) is not None:
                return int(env[name])
        raise ValueError(f"init_distributed at {addr} needs {' or '.join(names)} (or the argument)")

    world = value(num_processes, "JAX_NUM_PROCESSES", "WORLD_SIZE")
    rank = value(process_id, "JAX_PROCESS_ID", "RANK")
    if "://" not in addr:
        addr = f"tcp://{addr}"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank)
    return True


@dataclass(frozen=True)
class Sharding:
    """A placement of a tensor on a mesh (the JAX package's
    ``NamedSharding``): ``axis`` ``"dp"`` or ``"shard"`` splits the leading
    axis into that mesh axis's blocks, ``None`` replicates.
    :meth:`put` gives the ``[dp][shard]`` tuple of tensors that the
    collectives and the sharded NTT and LDE take."""

    mesh: Mesh
    axis: Optional[str] = None

    def put(self, x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """``x`` placed on every position of this process's grid: block
        ``d`` of ``dp`` contiguous blocks on each position of row ``d``
        (``"dp"``), block ``s`` of ``shard`` on each position of column
        ``s`` (``"shard"``), or the whole of ``x`` everywhere (``None``).
        A split's blocks hold ``ceil(len(x) / count)`` rows, the last ones
        fewer or none (no padding)."""
        rows = self.mesh.devices
        if self.axis is None:
            return tuple(tuple(x.to(dev) for dev in row) for row in rows)
        if self.axis not in ("dp", "shard"):
            raise ValueError(f"no mesh axis {self.axis!r}")
        count = len(rows) if self.axis == "dp" else len(rows[0])
        per = -(-x.shape[0] // count)
        blocks = [x[i * per : (i + 1) * per] for i in range(count)]
        return tuple(tuple(blocks[d if self.axis == "dp" else s].to(dev) for s, dev in enumerate(row))
                     for d, row in enumerate(rows))


def dp_sharding(mesh: Mesh) -> Sharding:
    """Batch-axis placement: the leading axis split across ``dp``."""
    return Sharding(mesh, "dp")


def replicated(mesh: Mesh) -> Sharding:
    """One copy on every position."""
    return Sharding(mesh, None)


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
