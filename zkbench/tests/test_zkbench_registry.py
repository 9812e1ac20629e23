"""BENCHMARK.json names its configurations, mixes and metrics, and the
harness finds each by name: a file under configs/, traffic/ and metrics/."""

import json
import re
from pathlib import Path

import pytest

from zkbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["pattern"] and set(c.traffic["pattern"]) <= set(c.config["kinds"])
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    readers = {p.stem for p in (REPO / "zkbench" / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).exists()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for name in cells:
        assert any(name in m.get("workloads", [name]) for m in BENCH["per_layer"])
