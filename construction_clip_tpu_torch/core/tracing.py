"""The port's spans and counters.

A span marks a stretch of host time at a layer boundary:

    with tracing.span("preprocess"):
        ...

It records (name, parent, thread, start_ns, end_ns) only while a
`torch.profiler` session is active, stamped with `time.time_ns()`, the clock
of the profiler's events, so that a span can be laid over the device trace
of the same session. The parent is the innermost span open on the same
thread. With no session active, `span` returns a shared null context after
one check: it never synchronises, reads a tensor or allocates. Spans are
kept in memory, the newest MAX_SPANS of them; `spans(lo_ns, hi_ns)` returns
those that overlap an interval.

Counters are always on: `count(name)` adds to a named count and `counters()`
takes a snapshot. The kernel wrappers count their launches under the
kernel's number, then its route: "k1" and "k1.tc", "k4.simt", "k6", "k10".
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

MAX_SPANS = 65536


class Span(NamedTuple):
    name: str
    parent: str | None   # the innermost span open on the same thread, if any
    thread: int          # threading.get_ident() of the thread that opened it
    start_ns: int
    end_ns: int


_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_OPEN = threading.local()
_NULL = contextlib.nullcontext()
_COUNTS: collections.defaultdict = collections.defaultdict(int)
_COUNTS_LOCK = threading.Lock()


class _Recording:
    __slots__ = ("name", "parent", "stack", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.stack = stack
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self.stack.pop()
        _SPANS.append(Span(self.name, self.parent, threading.get_ident(), self.start_ns, end))
        return False


def span(name: str):
    """A context manager that records a span named `name` while a
    torch.profiler session is active, and does nothing otherwise."""
    # the profiler sets this flag of its module on start and clears it on
    # stop, whatever activities it records
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name)


def spans(lo_ns: int | None = None, hi_ns: int | None = None) -> list[Span]:
    """The recorded spans that overlap [lo_ns, hi_ns], oldest first (all of
    them without bounds)."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    return [s for s in list(_SPANS) if s.end_ns >= lo and s.start_ns <= hi]


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name`."""
    with _COUNTS_LOCK:
        _COUNTS[name] += n


def counters() -> dict[str, int]:
    """A snapshot of every counter, {name: count}; a name never counted is
    absent."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)
