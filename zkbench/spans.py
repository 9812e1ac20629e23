"""Spans from the benchmark's own wrappers around the calls into each layer
of the program, installed for a traced run only.

What is wrapped is declared by the per-layer metric files that read it, so
that a metric added later brings its own spans and calls as a file:

* ``SPANS``: ``(span name, module, attribute)``. A span is ``(name,
  start_ns, end_ns)`` on the wall clock that the profiler's events use
  (``time.time_ns``).
* ``CALLS``: ``(call name, module, attribute)``. Each call is recorded as
  ``(name, args, kwargs)``, a tensor argument by its shape and element size
  (``Tensor``), any other by its value where it is a number, a string or
  None, else by its type's name.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Callable, Iterable, List, NamedTuple


class Tensor(NamedTuple):
    shape: tuple
    element_size: int


def _describe(x):
    if hasattr(x, "shape") and hasattr(x, "element_size"):
        return Tensor(tuple(x.shape), x.element_size())
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return type(x).__name__


def _targets(declared: Iterable[tuple]) -> dict:
    """Name → (module, attribute), one target a name and one name a target."""
    out: dict = {}
    for name, module, attr in declared:
        if out.setdefault(name, (module, attr)) != (module, attr):
            raise ValueError(f"{name!r} is declared on {out[name]} and on {(module, attr)}")
    if len(set(out.values())) != len(out):
        raise ValueError(f"one function under two names in {sorted(out)}")
    return out


class Recorder:
    def __init__(self, spans: Iterable[tuple] = (), calls: Iterable[tuple] = ()):
        self.span_targets = _targets(spans)
        self.call_targets = _targets(calls)
        self.spans: List[tuple] = []
        self.calls: List[tuple] = []
        self.active = False

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own, recorded while the wrappers are in."""
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self.active:
                self.spans.append((name, t0, time.time_ns()))

    def wrap_span(self, name: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapper

    def wrap_call(self, name: str, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if self.active:
                self.calls.append((name, tuple(_describe(a) for a in args),
                                   {k: _describe(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)
        return wrapper

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place of the program's functions, and the
        originals back after."""
        saved = []
        try:
            for targets, wrap in ((self.span_targets, self.wrap_span),
                                  (self.call_targets, self.wrap_call)):
                for name, (module, attr) in targets.items():
                    mod = importlib.import_module(module)
                    fn = getattr(mod, attr)
                    saved.append((mod, attr, fn))
                    setattr(mod, attr, wrap(name, fn))
            self.active = True
            yield self
        finally:
            self.active = False
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)
