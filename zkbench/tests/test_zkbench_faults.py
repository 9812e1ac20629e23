"""With the timed path broken underneath, a run comes out not correct: a
step that returns its state unchanged, half of each batch left out, a proof
altered where it is produced, and each cell's control. The comparison is
the run's own (``harness.run``): only the traffic is cut to a few ops a
batch, and on the CPU to the one kind that proves in milliseconds there.
The cells have one chip, so there is no exchange between chips to leave
out."""

import json
from pathlib import Path

import pytest

from zkbench import faults, harness

BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONTROL = {"bp-range64": "narrow", "libzkp-mixed6": "narrow"}
SEED = 2**33 + 7


def _small(cell, ops, pattern=None, seconds_batches=2):
    c = harness.Cell(cell)
    pattern = pattern or c.traffic["pattern"]
    c.traffic = dict(c.traffic, ops_per_batch=ops, pattern=pattern, max_batches=200,
                     trace_batches=seconds_batches,
                     sample_per_kind={k: ops for k in pattern})
    return c


@pytest.fixture(scope="module")
def cpu_cell():
    import torch

    torch.set_num_threads(1)
    return _small("mixed6.b1024", 4, ["improvement"])


@pytest.mark.parametrize("fault", [None, "stale", "half", "altered"])
def test_cpu_faults_come_out_not_correct(cpu_cell, fault):
    hook = faults.HOOKS[fault] if fault else None
    r = harness.run(cpu_cell, SEED, 0.3, False, device="cpu", hook=hook)
    assert r["correct"] is (fault is None), r["compared"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "stale", "half", "altered", "control"])
def test_card_faults_come_out_not_correct(card, cell, fault):
    c = _small(cell, 24)
    if fault == "control":
        fault = "foreign_keys" if set(c.traffic["pattern"]) <= {"equality", "membership"} \
            else CONTROL[c.config["name"]]
    hook = faults.HOOKS[fault] if fault else None
    r = harness.run(c, SEED, 1.0, False, device=card, hook=hook)
    assert r["correct"] is (fault is None), r["compared"]
