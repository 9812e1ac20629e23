"""The traffic mixes give the same ops for the same seed, in the shapes the
mix states, and ops that the program's validators accept."""

import json
from collections import Counter
from pathlib import Path

import pytest

from zkbench import traffic

MIXES = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
SEED = 2**31 + 12345


def _spec(name):
    return traffic.load(Path(__file__).resolve().parents[1] / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_ops(mix):
    spec = _spec(mix)
    assert traffic.batch(spec, SEED, 3) == traffic.batch(spec, SEED, 3)
    assert traffic.batch(spec, SEED, 3) != traffic.batch(spec, SEED + 1, 3)
    assert traffic.batch(spec, SEED, 3) != traffic.batch(spec, SEED, 4)


@pytest.mark.parametrize("mix", MIXES)
def test_shapes(mix):
    spec = _spec(mix)
    ops = traffic.batch(spec, SEED, -1)
    assert len(ops) == spec["ops_per_batch"]
    counts = Counter(kind for kind, _ in ops)
    per = spec["ops_per_batch"] // len(spec["pattern"])
    assert set(counts) == set(spec["pattern"])
    assert all(per <= c <= per + 1 for c in counts.values())
    for kind, args in ops:
        if kind == "membership":
            value, the_set = args
            assert len(set(the_set)) == spec["membership"]["set_size"] and value in the_set
        if kind == "consistency":
            assert len(args[0]) == spec["consistency"]["values"] and args[0] == sorted(args[0])
        if kind == "threshold":
            assert len(args[0]) == spec["threshold"]["values"]


@pytest.mark.parametrize("mix", MIXES)
def test_ops_valid_and_fit_the_narrow_control(mix):
    """Every op passes the program's validators, and every range and
    threshold difference fits 32 bits (so the 32-bit control can run)."""
    from libzkp_tpu_torch.utils import validation

    for kind, args in traffic.batch(_spec(mix), SEED, 0):
        getattr(validation, f"validate_{kind}_params")(*args)
        if kind == "range":
            value, lo, hi = args
            assert value - lo < 2**32 and hi - value < 2**32
        if kind == "threshold":
            assert 0 <= sum(args[0]) - args[1] < 2**32 and sum(args[0]) < 2**64


def test_mix_files_are_data():
    for mix in MIXES:
        json.loads((Path(__file__).resolve().parents[1] / "traffic" / f"{mix}.json").read_text())
