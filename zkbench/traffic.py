"""The one traffic generator: a mix's parameters (a JSON file under
``traffic/``) and a seed give the same batches of ``(kind, args)`` ops every
time.

Op ``i`` of a batch has kind ``pattern[i % len(pattern)]``. Every kind
draws its arguments from the seed in one fixed shape, so every seed asks
the same work of the prover in another order of values:

* ``range`` ``(value, min, max)``: ``min`` and the width ``max - min``
  uniform in the mix's intervals, ``value`` uniform in ``[min, max]``;
* ``equality`` ``(v, v)``: ``v`` uniform over u64;
* ``threshold`` ``(values, threshold)``: ``values`` values uniform in
  ``[0, value_max]``, the threshold uniform in ``[0, sum]``;
* ``membership`` ``(value, set)``: ``set_size`` distinct u64 values, the
  value one of them;
* ``improvement`` ``(old, new)``: ``old < new``, both u64;
* ``consistency`` ``(values,)``: ``values`` values uniform in
  ``[0, value_max]``, sorted.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import List, Tuple

U64 = (1 << 64) - 1
Op = Tuple[str, tuple]


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    for key in ("ops_per_batch", "pattern", "warmup_batches", "max_batches", "trace_batches",
                "sample_per_kind"):
        if key not in spec:
            raise ValueError(f"{path}: no {key!r}")
    return spec


def _op(kind: str, spec: dict, rng: random.Random) -> Op:
    p = spec.get(kind, {})
    if kind == "range":
        lo = rng.randint(*p["min"])
        hi = lo + rng.randint(*p["width"])
        return kind, (rng.randint(lo, hi), lo, hi)
    if kind == "equality":
        v = rng.randint(0, U64)
        return kind, (v, v)
    if kind == "threshold":
        values = [rng.randint(0, p["value_max"]) for _ in range(p["values"])]
        return kind, (values, rng.randint(0, sum(values)))
    if kind == "membership":
        the_set: List[int] = []
        while len(the_set) < p["set_size"]:
            v = rng.randint(0, U64)
            if v not in the_set:
                the_set.append(v)
        return kind, (rng.choice(the_set), the_set)
    if kind == "improvement":
        old = rng.randint(0, U64 - 1)
        return kind, (old, rng.randint(old + 1, U64))
    if kind == "consistency":
        return kind, (sorted(rng.randint(0, p["value_max"]) for _ in range(p["values"])),)
    raise ValueError(f"unknown op kind {kind!r}")


def batch(spec: dict, seed: int, index: int) -> List[Op]:
    """Batch ``index`` of the mix under ``seed`` (warm-up batches have
    negative indices)."""
    rng = random.Random(f"{seed}:{index}")
    pattern = spec["pattern"]
    return [_op(pattern[i % len(pattern)], spec, rng) for i in range(spec["ops_per_batch"])]
