"""``proofs_per_s`` counts every batch the window began, to its end, over
all of the window's time: a stall anywhere lowers it."""

import pytest

from zkbench import harness


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _loop(batch_seconds, seconds, ops=1024):
    clock = FakeClock()
    batches = [[("range", (1, 0, 2))] * ops for _ in range(len(batch_seconds))]
    costs = iter(batch_seconds)

    def prove(batch):
        clock.t += next(costs)
        return [b"p"] * len(batch)

    return harness.closed_loop(prove, batches, seconds, clock=clock)


def test_the_batch_at_the_deadline_is_finished_and_counts():
    done, window_s = _loop([2.0] * 10, 5.0)
    # batches begin at 0, 2 and 4 s; the third ends at 6 s
    assert len(done) == 3 and window_s == pytest.approx(6.0)
    assert harness.proofs_per_s(done, window_s) == pytest.approx(3 * 1024 / 6.0)


def test_no_batch_begins_after_the_deadline():
    done, window_s = _loop([2.5] * 10, 5.0)
    assert len(done) == 2 and window_s == pytest.approx(5.0)


def test_a_stall_lowers_the_rate():
    steady = harness.proofs_per_s(*_loop([2.0] * 10, 10.0))
    stalled = harness.proofs_per_s(*_loop([2.0, 2.0, 5.0, 2.0, 2.0, 2.0, 2.0], 10.0))
    assert stalled < steady
    # 2 + 2 + 5 + 2 = 11 s for four batches against 10 s for five
    assert stalled == pytest.approx(4 * 1024 / 11.0)


def test_a_failed_batch_ends_the_window_and_counts_nothing():
    clock = FakeClock()

    def prove(batch):
        clock.t += 1.0
        raise RuntimeError("planted")

    done, window_s = harness.closed_loop(prove, [[("range", (1, 0, 2))]] * 3, 10.0, clock=clock)
    assert len(done) == 1 and done[0][1] is None


def test_the_mix_must_outlast_the_window():
    with pytest.raises(RuntimeError):
        _loop([1.0] * 3, 10.0)
