"""The seam that puts the MSM kernels on the prove path.

Port of the JAX package's ``libzkp_tpu/ops/msm_device.py`` without its
gates: the batched host wrappers (``bn254.g1_msm_fixed_many`` and
``g2_msm_fixed_many``) call :func:`msm_fixed_many` on the entry point's
device, always. There is no autotune record, no environment knob, no
threshold and no catch-all: on a CUDA device the MSM runs on the kernels or
raises; on the CPU it runs their plain versions.

* Multiples tables of process-constant bases (proving-key query vectors and
  points) are cached in a bounded LRU keyed by value (curve, device,
  points), since callers rebuild the basis list per call. A basis that
  holds per-statement points is passed with ``cache=False``: its table is
  built for the one call and never enters the LRU, so it cannot evict a
  proving key's tables.
* Batches are cut into chunks of 512 lanes, each padded to a power of two,
  so the set of launch shapes stays small.
* The mesh route (JAX ``try_device``'s ``msm_many_sharded`` branch): when
  ``parallel.mesh.set_mesh`` names a mesh of more than one position, or
  ``use_mesh()`` holds (more than one CUDA device) on a CUDA entry device,
  the whole batch runs :func:`curve.msm_many_sharded` over that mesh. Its
  per-shard tables sit in the same LRU, keyed with the mesh. A failure on
  the mesh raises.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence

import torch

from ..parallel import mesh as meshmod
from . import curve

CHUNK_B = 512  # lanes per MSM launch sequence
_TABLES: "OrderedDict" = OrderedDict()
_MAX_TABLES = 16  # each entry holds a device table; bound the cache
_LOCK = threading.Lock()


def _build_table(curve_name: str, points: Sequence, where):
    """The basis's table on a device, or cut over a mesh (built on the
    mesh's first device, then sliced to each block's)."""
    eng = curve.get_engine(curve_name)
    base = eng.encode_points(list(points))
    if isinstance(where, meshmod.Mesh):
        built = curve.DeviceTable(base, device=where.devices[0][0], curve=curve_name)
        return curve.ShardedTable(built.table, built.K, where, curve=curve_name)
    return curve.DeviceTable(base, device=where, curve=curve_name)


def _get_table(curve_name: str, points: Sequence, where):
    key = (curve_name, where if isinstance(where, meshmod.Mesh) else str(where), tuple(points))
    with _LOCK:
        tbl = _TABLES.get(key)
        if tbl is not None:
            _TABLES.move_to_end(key)
            return tbl
    table = _build_table(curve_name, points, where)
    with _LOCK:
        _TABLES[key] = table
        while len(_TABLES) > _MAX_TABLES:
            _TABLES.popitem(last=False)
    return table


_mesh_for = meshmod.mesh_for  # the mesh the seam shards over, or None


def _dispatch(table: curve.DeviceTable, scalar_vecs: Sequence[Sequence[int]]) -> List:
    """Chunked, power-of-two padded :func:`curve.msm_many`."""
    out: List = []
    for i in range(0, len(scalar_vecs), CHUNK_B):
        part = list(scalar_vecs[i : i + CHUNK_B])
        b = len(part)
        padded = 1 << max(0, (b - 1)).bit_length()
        if padded > b:
            part = part + [[0] * len(part[0])] * (padded - b)
        out.extend(curve.msm_many(table, part)[:b])
    return out


def msm_fixed_many(curve_name: str, scalar_vecs: Sequence[Sequence[int]], points: Sequence, *,
                   device, cache: bool = True) -> List:
    """Independent MSMs of ``scalar_vecs`` over the fixed basis ``points``
    (host Jacobian points) on ``device``, or on the mesh (module docstring)
    -> host Jacobian points. With ``cache=False`` the basis's table is built
    for this call only."""
    if not scalar_vecs:
        return []
    dev = torch.device(device)
    get = _get_table if cache else _build_table
    mesh = _mesh_for(dev)
    if mesh is not None:
        return curve.msm_many_sharded(get(curve_name, points, mesh), scalar_vecs, mesh)
    return _dispatch(get(curve_name, points, dev), scalar_vecs)
