"""The metrics that read the program's own spans, on a synthetic trace and
synthetic program spans: only spans that start inside the window count a
batch, ``table.build_ms`` counts from the import to the window's end, and a
program without the recorder gives no value."""

import pytest

from zkbench import harness, program_spans
from zkbench.trace import Trace

MS = 1_000_000  # ns


class _Recorder:
    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return list(self._spans)


# (name, start_ns, end_ns, parent, batch): a warm-up batch before the window
# (0-100 ms), two batches inside it (200-300 and 300-400 ms), and a span
# still open (no end)
SPANS = [
    ("batch", 0, 100 * MS, -1, 1),
    ("table.build", 10 * MS, 40 * MS, 0, 1),
    ("g16.h.spmv", 50 * MS, 60 * MS, 0, 1),
    ("batch", 200 * MS, 300 * MS, -1, 2),
    ("bp.draw", 201 * MS, 203 * MS, 3, 2),
    ("bp.digits", 203 * MS, 206 * MS, 3, 2),
    ("bp.upload", 210 * MS, 211 * MS, 3, 2),
    ("bp.envelope", 290 * MS, 294 * MS, 3, 2),
    ("bp.transcript", 220 * MS, 230 * MS, 3, 2),
    ("g16.h.spmv", 240 * MS, 247 * MS, 3, 2),
    ("msm.digits", 250 * MS, 251 * MS, 3, 2),
    ("msm.walk", 251 * MS, 259 * MS, 3, 2),
    ("msm.decode", 259 * MS, 262 * MS, 3, 2),
    ("g16.finish", 270 * MS, 280 * MS, 3, 2),
    ("batch", 300 * MS, 400 * MS, -1, 3),
    ("table.build", 310 * MS, 315 * MS, 14, 3),
    ("g16.h.spmv", 320 * MS, 321 * MS, 14, 3),
    ("g16.finish", 330 * MS, 336 * MS, 14, 3),
    ("bp.draw", 340 * MS, 342 * MS, 14, 3),
    ("table.build", 500 * MS, 520 * MS, -1, None),  # after the window
    ("bp.draw", 399 * MS, None, 14, 3),
]


def _trace():
    return Trace(device_events=[("k", 205 * MS, MS)], spans=[], calls=[],
                 window=(200 * MS, 400 * MS), batches=2, proofs={"range": 4}, peaks=None)


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "tracing", _Recorder(SPANS))


@pytest.mark.parametrize("metric, cell, want", [
    ("bp.host_ms", "range64.b1024", (2 + 3 + 1 + 4 + 2) / 2),
    ("g16.spmv_ms", "mixed6.snark.b1024", (7 + 1) / 2),
    ("g16.finish_ms", "mixed6.snark.b1024", (10 + 6) / 2),
    ("msm.host_ms", "mixed6.b1024", (1 + 3) / 2),
    ("table.build_ms", "mixed6.b1024", 30 + 5),
])
def test_reader(recorder, metric, cell, want):
    assert harness.Cell(cell).reader(metric)(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["bp.host_ms", "g16.spmv_ms", "g16.finish_ms", "msm.host_ms",
                                    "table.build_ms"])
def test_nothing_to_read_is_no_value(monkeypatch, metric):
    cell = harness.Cell("mixed6.b1024")
    monkeypatch.setattr(program_spans, "tracing", None)  # a program without its recorder
    assert cell.reader(metric)(_trace()) is None
    monkeypatch.setattr(program_spans, "tracing", _Recorder([("stark", 210 * MS, 220 * MS, -1, 2)]))
    assert cell.reader(metric)(_trace()) is None


def test_the_import_turns_the_programs_recorder_on():
    from libzkp_tpu_torch.utils import tracing

    assert program_spans.tracing is tracing
    assert tracing.span("x") is not tracing.span("x")  # not the shared no-op


def test_every_new_metric_is_declared_on_its_cells():
    names = {"bp.host_ms", "g16.spmv_ms", "g16.finish_ms", "msm.host_ms", "table.build_ms"}
    for cell in ("range64.b1024", "mixed6.b1024", "mixed6.snark.b1024"):
        c = harness.Cell(cell)
        declared = {m["name"] for m in c.per_layer} & names
        assert all(m["source"] == "program_span" for m in c.per_layer if m["name"] in names)
        assert "table.build_ms" in declared
        assert ("bp.host_ms" in declared) == (cell != "mixed6.snark.b1024")
        assert ({"g16.spmv_ms", "g16.finish_ms", "msm.host_ms"} <= declared) == (cell != "range64.b1024")
