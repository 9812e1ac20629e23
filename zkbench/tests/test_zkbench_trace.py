"""The traced window's arithmetic: busy time as the union of device events,
idle time given to the innermost host span, the readers of the per-layer
metrics, and the roofline's yardstick."""

import json
from pathlib import Path

import pytest

from zkbench import harness, work
from zkbench.spans import Recorder, Tensor
from zkbench.trace import Trace

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


def _trace(**kw):
    base = dict(device_events=[("k", 10, 5), ("k", 12, 8), ("m", 60, 5)],
                spans=[("batch", 0, 100), ("bp.prove", 20, 50), ("stark", 55, 70)],
                calls=[], window=(0, 100), batches=1, proofs={"range": 2}, peaks=PEAKS)
    base.update(kw)
    return Trace(**base)


def test_busy_is_the_union_of_device_events():
    assert _trace().busy_s() == pytest.approx(15e-9)


def test_idle_goes_to_the_innermost_span():
    idle = dict(_trace().idle_by_span())
    # idle: 0-10 batch, 20-50 bp.prove, 50-55 batch, 55-60 stark, 65-70 stark, 70-100 batch
    assert idle == pytest.approx({"batch": 45e-9, "bp.prove": 30e-9, "stark": 10e-9})


def test_readers():
    cell = harness.Cell("mixed6.b1024")
    tr = _trace(device_events=[("k", 25, 5), ("k", 40, 5), ("m", 60, 5)])
    assert cell.reader("bp.device_ops_per_proof")(tr) == 1.0
    assert cell.reader("batch.self_ms")(tr) == pytest.approx((100 - 30 - 15) / 1e6)
    assert cell.reader("device.idle_share")(tr) == pytest.approx(85.0)
    assert cell.reader("g16.h_ms")(tr) is None  # nothing to read: no value, not 0
    assert cell.reader("window_sum_roofline")(tr) is None


def test_roofline_counts_the_algorithms_work():
    macs, nbytes = work.window_sum_work("ed25519", (160, 1024), 4 * 24 * 2)
    assert macs == 159 * 9 * (24 * 24 + 52) * 1024
    least = work.least_seconds(macs, nbytes, PEAKS)
    assert least == pytest.approx(macs / 1.672704e13)  # bound by operations
    cell = harness.Cell("range64.b1024")
    tr = _trace(device_events=[("window_sum_kernel", 10, int(4 * least * 1e9))],
                calls=[("window_sum", ("consts", Tensor((40960, 4, 24), 2), Tensor((160, 1024), 4)), {})])
    assert cell.reader("window_sum_roofline")(tr) == pytest.approx(25.0, rel=1e-4)
    g2 = [("window_sum4", ("c", Tensor((40960, 6, 24), 2), Tensor((4, 352, 256), 4)), {"curve": c})
          for c in ("bn254_g2", "bn254_g1")]
    macs, nbytes = work.window_sum_work("bn254_g2", (4, 352, 256), 6 * 24 * 2)
    least = work.least_seconds(macs, nbytes, PEAKS)
    tr = _trace(device_events=[("window_sum4_g2_kernel", 10, int(2 * least * 1e9))], calls=g2)
    assert cell.reader("window_sum4_g2_roofline")(tr) == pytest.approx(50.0, rel=1e-4)


class _Module:
    @staticmethod
    def f(x, *, curve=None):
        return x


def test_metric_files_declare_what_is_wrapped(monkeypatch):
    import sys
    import types

    import torch

    spans, calls = harness.Cell("mixed6.b1024").declared()
    assert {n for n, _, _ in spans} >= {"prehash", "stark", "bp.prove", "g16.h", "g16.msm"}
    assert {n for n, _, _ in calls} == {"window_sum", "window_sum4"}
    mod = types.ModuleType("zkbench_fake_program")
    mod.f, mod.g = _Module.f, _Module.f
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    rec = Recorder([("s", mod.__name__, "f")], [("c", mod.__name__, "g")])
    with rec.installed():
        mod.f(1)
        mod.g(torch.zeros(3, 2, dtype=torch.int16), curve="bn254_g2")
    assert mod.f is _Module.f and mod.g is _Module.f  # the originals are back
    mod.g(2)  # not recorded once the wrappers are out
    assert [s[0] for s in rec.spans] == ["s"]
    assert rec.calls == [("c", (Tensor((3, 2), 2),), {"curve": "bn254_g2"})]
    with pytest.raises(ValueError):
        Recorder([("s", mod.__name__, "f"), ("s", mod.__name__, "g")])
