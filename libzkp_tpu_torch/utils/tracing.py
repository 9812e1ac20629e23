"""Phase spans of the batch path, kept in memory.

``with span("bp.prove"): ...`` marks one phase of a batch. Recording is off
unless :func:`enable` was called, and then :func:`span` returns one shared
``contextlib.nullcontext()``: no clock read, no allocation. When on, each
span is recorded as ``(name, start_ns, end_ns, parent, batch)``:

* times from ``time.time_ns()``, the wall clock on which ``torch.profiler``
  stamps device events, so a device trace lines up with the spans;
* ``parent``, the index in :func:`spans` of the innermost span open on the
  same thread when this one began, -1 at a root;
* ``batch``, the id given to the span, else its parent's (the batch id that
  ``process_batch`` gives its root span), else None.

Spans sit at phase level (a batch records tens), never inside a loop over
ops, lanes or proofs. :func:`clear` is for a moment when no span is open.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

_OFF = contextlib.nullcontext()
_on = False
_records: List[list] = []  # [name, start_ns, end_ns, parent, batch]
_lock = threading.Lock()
_local = threading.local()  # .open: [(index, record)] of this thread's open spans


class _Span:
    __slots__ = ("name", "batch", "record")

    def __init__(self, name: str, batch: Optional[int]):
        self.name, self.batch = name, batch

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        parent, outer = stack[-1] if stack else (-1, None)
        batch = self.batch if self.batch is not None or outer is None else outer[4]
        with _lock:
            index = len(_records)
            self.record = [self.name, time.time_ns(), None, parent, batch]
            _records.append(self.record)
        stack.append((index, self.record))
        return self

    def __exit__(self, *exc) -> None:
        self.record[2] = time.time_ns()
        _local.open.pop()


def span(name: str, batch: Optional[int] = None):
    """A context manager over one phase; ``batch`` names the batch at a
    root span."""
    return _Span(name, batch) if _on else _OFF


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def spans() -> List[tuple]:
    """A copy of the spans recorded since the last :func:`clear`; a span
    still open has None for its end."""
    with _lock:
        return [tuple(r) for r in _records]


def clear() -> None:
    with _lock:
        _records.clear()
