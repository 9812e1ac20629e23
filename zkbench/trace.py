"""A traced window: the profiler's device events beside the benchmark's
spans, and the arithmetic the per-layer readers share."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Trace:
    def __init__(self, *, device_events, spans, calls, window, batches, proofs,
                 peaks: Optional[dict]):
        self.device_events: List[Tuple[str, int, int]] = sorted(device_events, key=lambda e: e[1])
        self.spans: List[tuple] = spans
        self.calls: List[tuple] = calls  # (name, args, kwargs), as spans.Recorder records them
        self.window: Tuple[int, int] = window  # (start_ns, end_ns)
        self.batches: int = batches
        self.proofs: Dict[str, int] = proofs  # proofs of each kind in the traced window
        self.peaks = peaks
        self._starts = [e[1] for e in self.device_events]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def named(self, name: str) -> List[tuple]:
        return [s for s in self.spans if s[0] == name]

    def span_ms_per_batch(self, name: str) -> Optional[float]:
        spans = self.named(name)
        if not spans or not self.batches:
            return None
        return sum(s[2] - s[1] for s in spans) / 1e6 / self.batches

    def events_in(self, spans) -> List[tuple]:
        """Device events that start inside any of ``spans``."""
        out = []
        for _, t0, t1 in spans:
            i = bisect.bisect_left(self._starts, t0)
            j = bisect.bisect_right(self._starts, t1)
            out.extend(self.device_events[i:j])
        return out

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device events' intervals, clipped to the window."""
        out: List[List[int]] = []
        lo, hi = self.window
        for _, start, dur in self.device_events:
            s, e = max(start, lo), min(start + dur, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, substring: str) -> float:
        return sum(d for name, _, d in self.device_events if substring in name) / 1e9

    def top_device_ops(self, count: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device_events:
            by[name] += dur / 1e9
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:count]]

    def idle_by_span(self, count: int = 10) -> List[list]:
        """The device's idle time inside the window, each stretch given to
        the innermost span the host was in (the latest begun of those that
        cover it), ``idle`` where none does; the largest ``count``."""
        lo, hi = self.window
        gaps, cur = [], lo
        for s, e in self.busy_intervals():
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
        # elementary intervals between span boundaries, each with its innermost span
        bounds = sorted({lo, hi} | {t for s in self.spans for t in (s[1], s[2]) if lo < t < hi})
        # the spans of one thread nest, so a stack holds the innermost one
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        owners, stack, nxt = [], [], 0
        for a, b in zip(bounds, bounds[1:]):
            while nxt < len(spans) and spans[nxt][1] <= a:
                stack.append(spans[nxt])
                nxt += 1
            while stack and stack[-1][2] <= a:
                stack.pop()
            owners.append(stack[-1][0] if stack else "idle")
        by: Dict[str, float] = defaultdict(float)
        j = 0
        for g0, g1 in gaps:
            while j < len(bounds) - 1 and bounds[j + 1] <= g0:
                j += 1
            k = j
            while k < len(bounds) - 1 and bounds[k] < g1:
                a, b = max(bounds[k], g0), min(bounds[k + 1], g1)
                if b > a:
                    by[owners[k]] += (b - a) / 1e9
                k += 1
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:count]]


def roofline_percent(trace: Trace, kernel: str, curve: str, event_name: str) -> Optional[float]:
    """The least time of the calls of the window-sum wrapper ``kernel``
    (``(consts, table, digits, *, curve)``, the curve ed25519 where not
    given) on ``curve`` over the device time of the events named
    ``event_name``, in percent; None where there is nothing to read."""
    from .work import least_seconds, window_sum_work

    if trace.peaks is None:
        return None
    least = 0.0
    for name, args, kwargs in trace.calls:
        if name != kernel or kwargs.get("curve", "ed25519") != curve:
            continue
        table, digits = args[1], args[2]
        row_bytes = table.shape[1] * table.shape[2] * table.element_size
        least += least_seconds(*window_sum_work(curve, digits.shape, row_bytes), trace.peaks)
    device_s = trace.kernel_seconds(event_name)
    if least <= 0 or device_s <= 0:
        return None
    return 100.0 * least / device_s
