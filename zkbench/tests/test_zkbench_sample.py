"""The proofs that the reference checks stride over the positions of a
batch, so every device lane is as likely to be checked as any other."""

import random
from collections import Counter

import pytest

from zkbench import harness


def _lanes(batches, counts):
    return [{kind: [(kind, (b, i), b"p") for i in range(n)] for kind, n in counts.items()}
            for b in range(batches)]


@pytest.mark.parametrize("batches, m, n", [(10, 1024, 384), (6, 512, 96), (4, 171, 48), (3, 8, 8)])
def test_draws_stride_over_positions_and_batches(batches, m, n):
    items = harness.draw_sample(_lanes(batches, {"range": m}), {"range": n}, random.Random(5))
    assert len(items) == n == len({args for _, args, _ in items})
    positions = sorted(args[1] for _, args, _ in items)
    gaps = [(b - a) for a, b in zip(positions, positions[1:])] + [positions[0] + m - positions[-1]]
    assert max(gaps) - min(gaps) <= 1  # evenly spread over the batch's positions
    per_batch = Counter(args[0] for _, args, _ in items)
    assert max(per_batch.values()) - min(per_batch.values()) <= 1


def test_every_position_is_drawn_over_seeds():
    lanes = _lanes(4, {"range": 171, "membership": 170})
    seen = Counter()
    for seed in range(400):
        for kind, args, _ in harness.draw_sample(lanes, {"range": 16, "membership": 16},
                                                 random.Random(seed)):
            seen[kind, args[1]] += 1
    assert {p for k, p in seen if k == "range"} == set(range(171))
    assert {p for k, p in seen if k == "membership"} == set(range(170))


def test_missing_proofs_are_not_drawn():
    lanes = _lanes(2, {"range": 8})
    for b in lanes:
        b["range"][3] = None
    items = harness.draw_sample(lanes, {"range": 16, "equality": 4}, random.Random(1))
    assert len(items) == 14 and all(args[1] != 3 for _, args, _ in items)
