"""The port's span recorder (``libzkp_tpu_torch/utils/tracing.py``) and the
phase spans of the batch path.

* Off, the default: ``span`` hands back one shared no-op and records
  nothing.
* The recorder itself: parents by thread, batch ids inherited.
* On: one op of each kind through ``process_batch`` on the CPU, under a
  seeded ``os.urandom``, gives the same envelopes as with the recorder off,
  and records exactly the phase spans of that batch, each inside its parent
  and the call, under the batch's id.
* A range batch of 8 ops and one of 32 record the same spans: none is per
  op.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter

import pytest
import torch
from test_torch_batch import OPS, _Stream, shared_keys  # noqa: F401 (a fixture)

import libzkp_tpu_torch as zkp
from libzkp_tpu_torch.advanced import batch as tbatch
from libzkp_tpu_torch.models import bp_device
from libzkp_tpu_torch.utils import tracing

# each span of a batch of every kind, with the spans it may lie directly in
PARENTS = {
    "batch": set(),
    "prehash": {"batch"},
    "g16.equality": {"batch"},
    "g16.membership": {"batch"},
    "g16.assign": {"g16.equality", "g16.membership"},
    "g16.h": {"g16.equality", "g16.membership"},
    "g16.h.spmv": {"g16.h"},
    "g16.h.ntt": {"g16.h"},
    "g16.msm": {"g16.equality", "g16.membership"},
    "g16.finish": {"g16.equality", "g16.membership"},
    "msm.digits": {"g16.msm", "g16.finish", "bp.prepare"},
    "msm.walk": {"g16.msm", "g16.finish", "bp.prepare"},
    "msm.decode": {"g16.msm", "g16.finish", "bp.prepare"},
    "bp.prepare": {"batch"},
    "bp.prove": {"batch"},
    "bp.draw": {"bp.prove"},
    "bp.digits": {"bp.prove"},
    "bp.transcript": {"bp.prove", "bp.poly", "bp.ipp"},
    "bp.upload": {"bp.prove"},
    "bp.poly": {"bp.prove"},
    "bp.ipp": {"bp.prove"},
    "bp.assemble": {"bp.prove"},
    "bp.envelope": {"bp.prove"},
    "stark": {"batch"},
    "stark.lde": {"stark"},
    "stark.prove": {"stark"},
}
# a multiples table built where it is first needed (a cold one only)
TABLE_PARENTS = {"g16.msm", "g16.finish", "bp.prepare", "bp.prove"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in every torch test module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Each test starts and ends with the recorder off and empty, and an
    empty batch registry."""
    tracing.disable()
    tracing.clear()
    tbatch._reset_for_tests()
    yield
    tracing.disable()
    tracing.clear()
    tbatch._reset_for_tests()


def _batch(ops) -> int:
    bid = zkp.create_proof_batch()
    for kind, args in ops:
        getattr(zkp, f"batch_add_{kind}_proof")(bid, *args)
    return bid


def _one_span(name: str) -> None:
    with tracing.span(name):
        pass


def test_off_is_one_shared_no_op():
    first = tracing.span("batch", batch=1)
    assert isinstance(first, contextlib.nullcontext)
    assert tracing.span("bp.prove") is first
    with first, tracing.span("bp.draw"):
        pass
    assert tracing.spans() == []


def test_parents_by_thread_and_inherited_batch_ids():
    tracing.enable()
    with tracing.span("batch", batch=7):
        with tracing.span("bp.prove"):
            with tracing.span("bp.draw"):
                pass
            other = threading.Thread(target=_one_span, args=("stark",))
            other.start()
            other.join(timeout=30)
            assert not other.is_alive()
        with tracing.span("stark"):
            pass
    with tracing.span("prehash"):
        pass
    spans = tracing.spans()
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("batch", -1, 7), ("bp.prove", 0, 7), ("bp.draw", 1, 7),
        ("stark", -1, None),  # a root on its own thread
        ("stark", 0, 7), ("prehash", -1, None)]
    assert all(s[1] <= s[2] for s in spans)
    tracing.clear()
    assert tracing.spans() == []


def test_six_kinds_same_envelopes_and_their_phase_spans(monkeypatch, shared_keys):  # noqa: F811
    """One op of each kind, the recorder off and then on, under one seeded
    ``os.urandom`` stream each time."""
    with monkeypatch.context() as m:
        bid = _batch(OPS)
        m.setattr(os, "urandom", _Stream(b"traced batch"))
        off = zkp.process_batch(bid, device="cpu")
    assert tracing.spans() == []

    bid = _batch(OPS)
    tracing.enable()
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", _Stream(b"traced batch"))
        t0 = time.time_ns()
        on = zkp.process_batch(bid, device="cpu")
        t1 = time.time_ns()
    tracing.disable()
    assert on == off

    spans = tracing.spans()
    names = Counter(s[0] for s in spans)
    assert set(names) - {"table.build"} == set(PARENTS)
    assert names["batch"] == 1 and spans[0][0] == "batch" and spans[0][3] == -1
    assert names["bp.transcript"] == 2 * 9  # two prover groups (16- and 18-byte labels)
    for name, start, end, parent, batch in spans:
        assert t0 <= start <= end <= t1, name
        assert batch == bid, name
        if name == "batch":
            continue
        p_name, p_start, p_end, _, p_batch = spans[parent]
        assert p_name in (TABLE_PARENTS if name == "table.build" else PARENTS[name]), (name, p_name)
        assert p_start <= start <= end <= p_end and p_batch == batch, name


def test_range_batch_spans_do_not_grow_with_its_ops():
    bp_device._basis_table(bp_device.N_BITS, torch.device("cpu"))  # built before either batch
    tracing.enable()
    counts = []
    for n in (8, 32):
        tracing.clear()
        zkp.process_batch(_batch([("range", (i * 7, 0, 300)) for i in range(n)]), device="cpu")
        counts.append(Counter(s[0] for s in tracing.spans()))
    assert counts[0] == counts[1]
    assert counts[0]["batch"] == 1 and counts[0]["bp.transcript"] == 9
