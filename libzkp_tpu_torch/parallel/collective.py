"""Collective layer: what the mesh-sharded MSM needs across devices.

Port of ``reduce_points`` from the JAX package's
``libzkp_tpu/parallel/collective.py``. Point addition is not a reduction
that a collective library knows, so the partial sums of one group are
brought to the group's first device and tree-folded there. The named-axis
wrappers (``psum``, ``all_to_all``, ``ppermute``) belong to the sharded NTT
and MiMC batch and are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


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
