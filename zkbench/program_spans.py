"""The program's own spans, for the per-layer metrics that read them.

The program records spans of its batch path in memory
(``libzkp_tpu_torch.utils.tracing``: ``(name, start_ns, end_ns, parent,
batch)`` on ``time.time_ns()``, the clock of the traced window and of the
profiler's device events). Importing this module turns that recorder on.
The harness imports a cell's metric files only in a traced run
(``Cell.declared`` before the warm-up batch, ``Cell.reader`` after the
window), so a run with ``--trace 0`` imports none of them and takes its
end-to-end numbers with the recorder off.

A program without the recorder gives no spans, and every reader here
returns None.
"""

from __future__ import annotations

from typing import List, Optional

try:
    from libzkp_tpu_torch.utils import tracing
except ImportError:  # a program from before its recorder
    tracing = None
else:
    tracing.enable()


def recorded() -> List[tuple]:
    """Every finished span the program has recorded since the import."""
    if tracing is None:
        return []
    return [s for s in tracing.spans() if s[2] is not None]


def in_window(trace) -> List[tuple]:
    """The program's spans that start inside ``trace.window``."""
    lo, hi = trace.window
    return [s for s in recorded() if lo <= s[1] <= hi]


def ms_per_batch(trace, *names: str) -> Optional[float]:
    """The summed duration of the spans named ``names`` inside the window,
    in ms a batch; None where there is none."""
    spans = [s for s in in_window(trace) if s[0] in names]
    if not spans or not trace.batches:
        return None
    return sum(s[2] - s[1] for s in spans) / 1e6 / trace.batches


def ms_until_window_end(trace, name: str) -> Optional[float]:
    """The summed duration of the spans named ``name`` that start before the
    window's end, from the import on (the warm-up batch included), in ms a
    run; None where there is none."""
    spans = [s for s in recorded() if s[0] == name and s[1] <= trace.window[1]]
    if not spans:
        return None
    return sum(s[2] - s[1] for s in spans) / 1e6
