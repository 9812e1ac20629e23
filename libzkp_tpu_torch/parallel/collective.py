"""Collective layer: named-axis collectives over a mesh's positions.

Port of the JAX package's ``libzkp_tpu/parallel/collective.py``. There each
collective runs inside ``shard_map`` on one controller; here each one is a
function over the per-position tensors of a
:class:`~libzkp_tpu_torch.parallel.mesh.Mesh`: a ``[dp][shard]`` tuple of
tensors, each on its position's device (what
:meth:`~libzkp_tpu_torch.parallel.mesh.Sharding.put` gives), and it returns
one in the same layout. Within a process the members of an axis group are
brought together by ``.to`` copies (a peer copy between cards, a no-op where
the mesh repeats a device).

Across processes only ``dp`` spans them (:func:`.mesh.init_distributed`),
and a ``dp`` member's global index is ``process_index * dp_local + d``:
:func:`psum` and :func:`all_gather` over ``dp`` fold this process's rows and
then ``dist.all_reduce`` or ``dist.all_gather`` the result;
:func:`all_to_all` sends every other process, in one
``dist.all_to_all_single``, the chunks its rows owe that process's rows; and
:func:`ppermute` posts the sends and receives of every pair whose ends lie in
different processes in one ``dist.batch_isend_irecv``. Pairs within a
process stay ``.to`` copies. Integer types whose sums wrap cross processes
as int64, which every backend takes.

:func:`reduce_points` folds partial curve-point sums, which no collective
library can add, on the group's first device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

Parts = Tuple[Tuple[torch.Tensor, ...], ...]

# integer types whose sums wrap at their width, as jnp's do: summed in int64
# and wrapped back (torch on the CPU adds no uint32)
_WRAP_BITS = {torch.uint8: 8, torch.int8: 8, torch.int16: 16, torch.uint16: 16,
              torch.int32: 32, torch.uint32: 32}
_SIGNED = {torch.int8, torch.int16, torch.int32}


def axis_size(axis: str, *, mesh: Mesh) -> int:
    """The number of members of ``axis``: ``dp`` counts every process's rows."""
    if axis == "dp":
        return mesh.processes * len(mesh.devices)
    if axis == "shard":
        return len(mesh.devices[0])
    raise ValueError(f"no mesh axis {axis!r}")


def axis_index(axis: str, *, mesh: Mesh) -> Tuple[Tuple[int, ...], ...]:
    """Each position's index along ``axis``, as a ``[dp][shard]`` tuple of
    ints (a ``dp`` index is global: ``process_index * dp_local + d``)."""
    dp, shard = len(mesh.devices), len(mesh.devices[0])
    if axis == "dp":
        return tuple((mesh.process_index * dp + d,) * shard for d in range(dp))
    if axis == "shard":
        return (tuple(range(shard)),) * dp
    raise ValueError(f"no mesh axis {axis!r}")


def _groups(axis: str, mesh: Mesh) -> List[List[Tuple[int, int]]]:
    """The positions ``(d, s)`` of each group of ``axis`` on this process's
    grid, in axis order."""
    dp, shard = len(mesh.devices), len(mesh.devices[0])
    if axis == "dp":
        return [[(d, s) for d in range(dp)] for s in range(shard)]
    if axis == "shard":
        return [[(d, s) for s in range(shard)] for d in range(dp)]
    raise ValueError(f"no mesh axis {axis!r}")


def _spans(axis: str, mesh: Mesh) -> bool:
    return axis == "dp" and mesh.processes > 1


def _check(x: Parts, mesh: Mesh) -> None:
    if len(x) != len(mesh.devices) or any(len(r) != len(m) for r, m in zip(x, mesh.devices)):
        raise ValueError(f"parts of {len(x)} x {len(x[0]) if x else 0} positions for a mesh of "
                         f"{len(mesh.devices)} x {len(mesh.devices[0])}")


def _scatter(outs: dict, mesh: Mesh) -> Parts:
    """``outs[(d, s)]`` onto position (d, s)'s device, as a ``[dp][shard]`` tuple."""
    return tuple(tuple(outs[(d, s)].to(dev) for s, dev in enumerate(row))
                 for d, row in enumerate(mesh.devices))


def _wrapped_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of ``parts`` (all on one device) with the wrap-around of
    their integer width."""
    dtype = parts[0].dtype
    bits = _WRAP_BITS.get(dtype)
    if bits is None:
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total
    total = parts[0].to(torch.int64)
    for p in parts[1:]:
        total = total + p.to(torch.int64)
    return _wrap(total, dtype)


def _wrap(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bits = _WRAP_BITS.get(dtype)
    if bits is None:
        return total
    total = total & ((1 << bits) - 1)
    if dtype in _SIGNED:
        total = torch.where(total >= 1 << (bits - 1), total - (1 << bits), total)
    return total.to(dtype)


def psum(x: Parts, axis: str = "dp", *, mesh: Mesh) -> Parts:
    """Sum-reduce across a mesh axis: every member of a group gets the sum
    of the group's parts (integer sums wrap at their width, as jnp's do).
    Over a ``dp`` that spans processes, each process's fold is then summed
    by ``dist.all_reduce``."""
    _check(x, mesh)
    groups = _groups(axis, mesh)
    outs = {}
    for group in groups:
        dev = x[group[0][0]][group[0][1]].device
        total = _wrapped_sum([x[d][s].to(dev) for d, s in group])
        if _spans(axis, mesh):
            dtype = total.dtype
            wide = total.to(torch.int64) if dtype in _WRAP_BITS else total
            dist.all_reduce(wide, op=dist.ReduceOp.SUM)
            total = _wrap(wide, dtype)
        for pos in group:
            outs[pos] = total
    return _scatter(outs, mesh)


def _gathered(x: Parts, axis: str, group, mesh: Mesh) -> List[torch.Tensor]:
    """The parts of ``group``'s members in axis order, on its first device;
    over a ``dp`` that spans processes, every process's rows."""
    dev = x[group[0][0]][group[0][1]].device
    local = [x[d][s].to(dev) for d, s in group]
    if not _spans(axis, mesh):
        return local
    mine = torch.stack(local)
    dtype = mine.dtype
    if dtype in _WRAP_BITS:  # carried as int64: the backends take no uint32
        mine = mine.to(torch.int64)
    every = [torch.empty_like(mine) for _ in range(mesh.processes)]
    dist.all_gather(every, mine.contiguous())
    return [row.to(dtype) for rows in every for row in rows.unbind(0)]


def all_gather(x: Parts, axis: str = "shard", *, mesh: Mesh, gather_axis: int = 0,
               tiled: bool = False) -> Parts:
    """Gather the parts of an axis group into every member: stacked on a new
    axis ``gather_axis`` (``tiled=False``) or concatenated along it
    (``tiled=True``), in the axis's order."""
    _check(x, mesh)
    groups = _groups(axis, mesh)
    outs = {}
    for group in groups:
        members = _gathered(x, axis, group, mesh)
        total = torch.cat(members, dim=gather_axis) if tiled else torch.stack(members, dim=gather_axis)
        for pos in group:
            outs[pos] = total
    return _scatter(outs, mesh)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backends carry it: the wrapping integer types as int64."""
    return t.to(torch.int64) if t.dtype in _WRAP_BITS else t


def _chunks(x: Parts, group, n: int, split_axis: int, tiled: bool) -> List[List[torch.Tensor]]:
    """Each local member's part of ``group`` cut into its ``n`` chunks along
    ``split_axis``, chunk i for member i: blocks (``tiled``) or the entries
    of an axis of size ``n``."""
    if tiled:
        chunks = [list(x[d][s].chunk(n, dim=split_axis)) for d, s in group]
        if any(len(c) != n or c[0].shape != c[-1].shape for c in chunks):
            raise ValueError(f"all_to_all: dimension {split_axis} does not split into {n} blocks")
        return chunks
    if any(x[d][s].shape[split_axis] != n for d, s in group):
        raise ValueError(f"all_to_all: dimension {split_axis} is not the axis size {n}")
    return [list(x[d][s].unbind(split_axis)) for d, s in group]


def all_to_all(x: Parts, axis: str, split_axis: int, concat_axis: int, *, mesh: Mesh,
               tiled: bool = True) -> Parts:
    """Transpose a dimension across a mesh axis (the four-step NTT's
    exchange): member j's part is cut along ``split_axis`` into one chunk
    per member, chunk i goes to member i, and each member joins what it
    gets in the senders' order along ``concat_axis`` (``tiled=True``: the
    block transpose; ``tiled=False``: ``split_axis`` has one entry per
    member, taken away, and the senders stack on a new ``concat_axis``).
    Over a ``dp`` that spans processes, every process's rows take part."""
    _check(x, mesh)
    n = axis_size(axis, mesh=mesh)
    outs = {}
    for group in _groups(axis, mesh):
        dev = x[group[0][0]][group[0][1]].device
        chunks = _chunks(x, group, n, split_axis, tiled)  # [local source][global destination]
        if _spans(axis, mesh):
            chunks = _exchange(chunks, mesh.process_index, mesh.processes, dev)
        for i, (d, s) in enumerate(group):
            me = mesh.process_index * len(group) + i if _spans(axis, mesh) else i
            got = [c[me].to(x[d][s].device) for c in chunks]  # every source, in axis order
            outs[(d, s)] = torch.cat(got, dim=concat_axis) if tiled else torch.stack(got, dim=concat_axis)
    return _scatter(outs, mesh)


def _exchange(chunks: List[List[torch.Tensor]], rank: int, processes: int, dev) -> List[List[torch.Tensor]]:
    """One ``dist.all_to_all_single`` of a group's chunks: ``chunks[d][j]``,
    from this process's member d to the global member j, in; the chunks of
    every source in axis order that this process's members get out, as
    ``[global source][global destination]`` with only this process's
    destinations filled."""
    local = len(chunks)
    dtype = chunks[0][0].dtype
    # send[q][d][e]: from local member d to member e of process q
    send = torch.stack([torch.stack([torch.stack([_wire(chunks[d][q * local + e]).to(dev)
                                                  for e in range(local)]) for d in range(local)])
                        for q in range(processes)]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)  # recv[q][d][e]: from member d of process q to local member e
    n = processes * local
    out = [[None] * n for _ in range(n)]
    for q in range(processes):
        for d in range(local):
            for e in range(local):
                out[q * local + d][rank * local + e] = recv[q, d, e].to(dtype)
    return out


def ppermute(x: Parts, axis: str, perm, *, mesh: Mesh) -> Parts:
    """Point-to-point exchange across a mesh axis: for each ``(src, dst)``
    of ``perm`` the member ``dst`` gets member ``src``'s part; a member no
    pair sends to gets zeros. Over a ``dp`` that spans processes the pairs
    whose ends lie in different processes go through one
    ``dist.batch_isend_irecv``."""
    _check(x, mesh)
    n = axis_size(axis, mesh=mesh)
    src_of = {int(b): int(a) for a, b in perm}
    srcs = set(src_of.values())
    if len(src_of) != len(perm) or len(srcs) != len(perm) or not all(0 <= i < n for i in srcs | set(src_of)):
        raise ValueError(f"ppermute: {perm} is no permutation of {n} members")
    spans = _spans(axis, mesh)
    outs, ops, received = {}, [], []
    for k, group in enumerate(_groups(axis, mesh)):
        base = mesh.process_index * len(group) if spans else 0
        mine = {base + i: pos for i, pos in enumerate(group)}  # global member -> local position
        for dst, src in sorted(src_of.items()):
            tag = (k * n + src) * n + dst
            if src in mine and dst not in mine:
                a, b = mine[src]
                ops.append(dist.P2POp(dist.isend, _wire(x[a][b]).contiguous(), dst // len(group), tag=tag))
            elif dst in mine and src not in mine:
                d, s = mine[dst]
                buf = torch.empty_like(_wire(x[d][s]))
                ops.append(dist.P2POp(dist.irecv, buf, src // len(group), tag=tag))
                received.append(((d, s), buf))
            elif dst in mine:
                (a, b), (d, s) = mine[src], mine[dst]
                outs[(d, s)] = x[a][b].to(x[d][s].device)
        for d, s in group:
            outs.setdefault((d, s), torch.zeros_like(x[d][s]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for (d, s), buf in received:
        outs[(d, s)] = buf.to(x[d][s].dtype)
    return _scatter(outs, mesh)


def reduce_points(add_fn: Callable, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold the partial point sums ``parts`` (one ``(C, n, B)`` tensor per
    member of the group, each on its own device) into their total, on the
    first one's device.

    The parts are copied there with ``.to`` (a peer copy between cards, a
    no-op where the mesh repeats a device), then added in the JAX pairing:
    part i with part i + half, an odd last part carried to the next level, so
    the limbs equal the JAX function's. ``add_fn(a, b)`` adds two such
    tensors (``kernels.pair_add`` on a card, its plain version on the CPU)."""
    dev = parts[0].device
    level = [p.to(dev) for p in parts]
    while len(level) > 1:
        half = len(level) // 2
        nxt = [add_fn(level[i], level[i + half]) for i in range(half)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]
