"""Spans at the program's layer boundaries, for the profiler's trace and
an in-memory recorder.

``with span("sweep.finalize"): ...`` marks one stretch of a layer's
host time.  What it costs depends on who is looking:

- nothing records: one check of ``torch.autograd._profiler_enabled()``
  and of the recorder, then a shared ``contextlib.nullcontext()``: no
  allocation, no clock read;
- ``torch.profiler`` records on this thread: the span opens
  ``torch.profiler.record_function(name)``, so it lies in the profiler's
  trace on the clock of the card's kernels and copies (the profiler
  records the thread that started it; spans on other threads reach only
  the recorder);
- the recorder is open (``with recording() as rec:``): the span appends
  a :class:`SpanRecord`, stamped by ``time.perf_counter_ns()``.

A span's parent is the innermost recorded span open on its thread;
:func:`adopt` hands a span to another thread (``Sweeper.run``'s
workers), so a preparation on a worker is a child of its ``sweep.run``.
A span with no parent draws a new run id, its descendants share it.
``span(name, timed=True)`` always reads the clock, for the callers that
keep its ``seconds`` (a sweep row's ``prepare`` stage).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch

from repro_torch.analysis import locks

#: the recorder's records are appended from several threads at once
_lock = locks.make_lock("spans")
_NULL = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None
_runs = itertools.count()
_tls = threading.local()


class SpanRecord(NamedTuple):
    name: str
    run: int               # shared by a top-level span and its descendants
    parent: Optional[int]  # index of the parent's record, None at the top
    thread: int            # ``threading.get_ident()`` of the opening thread
    start_ns: int          # ``time.perf_counter_ns()``
    end_ns: int


def _stack() -> List["Span"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class Span:
    """One open span; ``seconds`` once it has closed."""

    __slots__ = ("name", "index", "run", "parent", "start_ns", "end_ns",
                 "_fn", "_rec")

    def __init__(self, name: str):
        self.name = name
        self.index = self.run = self.parent = self._fn = self._rec = None

    def __enter__(self) -> "Span":
        rec = _recorder
        if rec is not None:
            stack = _stack()
            rec._open(self, stack[-1] if stack else None)
            if self.index is not None:
                stack.append(self)
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        if self.index is not None:
            _stack().pop()
            self._rec._close(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, timed: bool = False):
    """A span named ``name``; with ``timed`` it reads the clock even
    when nothing records."""
    if _recorder is None and not torch.autograd._profiler_enabled():
        return Span(name) if timed else _NULL
    return Span(name)


class _Adopted:
    __slots__ = ("parent",)

    def __init__(self, parent: Span):
        self.parent = parent

    def __enter__(self) -> None:
        _stack().append(self.parent)

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        return False


def adopt(parent: Optional[Span]):
    """Within the block, spans this thread opens take ``parent`` (a span
    another thread opened, or ``None``) as theirs."""
    if parent is None or parent.index is None:
        return _NULL
    return _Adopted(parent)


class Recorder:
    """The spans of one :func:`recording`, at most ``capacity`` of them
    (``dropped`` counts the rest); read after the work."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.dropped = 0
        self._records: List[Optional[SpanRecord]] = []

    def _open(self, s: Span, parent: Optional[Span]) -> None:
        ours = parent is not None and parent._rec is self
        with _lock:
            if len(self._records) >= self.capacity:
                self.dropped += 1
                return
            self._records.append(None)
            s.index = len(self._records) - 1
            s.run = parent.run if ours else next(_runs)
        s.parent = parent.index if ours else None
        s._rec = self

    def _close(self, s: Span) -> None:
        # the slot is this span's alone: storing one list item needs no lock
        self._records[s.index] = SpanRecord(
            s.name, s.run, s.parent, threading.get_ident(), s.start_ns,
            s.end_ns)

    def spans(self) -> List[SpanRecord]:
        """The closed spans, in the order they opened."""
        with _lock:
            return [r for r in self._records if r is not None]


@contextlib.contextmanager
def recording(capacity: int = 100_000) -> Iterator[Recorder]:
    """Record every span opened in the block, on any thread; one
    recorder at a time."""
    global _recorder
    rec = Recorder(capacity)
    with _lock:
        if _recorder is not None:
            raise RuntimeError("a span recorder is already open")
        _recorder = rec
    try:
        yield rec
    finally:
        with _lock:
            _recorder = None
