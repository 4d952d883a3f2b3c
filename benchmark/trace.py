"""The window of a run, its traced stretch and what is read from the trace.

`drive` runs a cell's unit of work (a batch or a step) in a closed loop for
the window's seconds. In a `--trace 1` run it records a stretch of whole
units in the middle of the window under `torch.profiler`; the profiler's
start, stop and reading are left out of the window. On a card the profiler
records device activity and the CUDA runtime calls alone (CUPTI), not the
host's operators: recording every operator slows the host, and a cell that
the host paces would then read the profiler. The stretch opens and closes with a
synchronise; its bounds and each unit's span are taken on the host's
real-time clock, the clock of the profiler's events, and every device
interval is clipped to the stretch.
"""

from __future__ import annotations

import bisect
import re
import time
import types
from collections import defaultdict

import torch

_ANON = re.compile(r"\(anonymous namespace\)::")
HOST = "(host code)"   # an idle gap in which the host was in no traced call
# CUPTI's own records of the host blocked: on a full launch queue, and on
# the profiler's buffers
BLOCKED = ("Command Buffer Full", "Activity Buffer Request")
def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces and parameters:
    'void cct::gemm_tc<1, false, 64, 128>(CUtensorMap, ...)' -> 'gemm_tc<1, false, 64, 128>'."""
    s = _ANON.sub("", name)
    depth, cut = 0, None
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = s[:cut] if cut is not None else s
    depth, last_space, last_ns = 0, -1, -1
    for i, ch in enumerate(head):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == " ":
            last_space = i
        elif depth == 0 and head[i: i + 2] == "::":
            last_ns = i + 1
    out = head[max(last_space, last_ns) + 1:].strip()
    return out or name.strip()


def warm() -> None:
    """A short profile outside the window, so that the profiler's own set-up
    (CUPTI's) is paid in set-up."""
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    with profile(activities=_activities(cuda)):
        torch.ones(8, device="cuda" if cuda else "cpu").sum()
        if cuda:
            torch.cuda.synchronize()


def _activities(cuda: bool) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def drive(unit, seconds: float, cuda: bool, trace_units: int = 0):
    """Runs unit() back to back for `seconds` of host time and closes with a
    synchronise. With trace_units, the units from the window's middle on
    run in a traced stretch of that many. Returns the window's record:
    `window_s`, `units`, `unit_s` (each unit's host seconds), `plain_units`
    and `plain_s`, the units before the stretch (all of them without one)
    and their wall time up to a synchronise, which no profiler touched, and
    `traced_from`, the stretch's first unit; `stretch` is read after the
    window by `Stretch.read`."""
    unit_s, stretch, paused, traced_from, plain_s = [], None, 0.0, None, None

    def timed():
        t = time.perf_counter()
        unit()
        unit_s.append(time.perf_counter() - t)

    _sync(cuda)
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0 - paused
        if trace_units and stretch is None and elapsed >= seconds / 2:
            _sync(cuda)
            t, traced_from = time.perf_counter(), len(unit_s)
            plain_s = t - t0
            stretch = profile_stretch(timed, trace_units, cuda)
            paused = time.perf_counter() - t - stretch.units_s
            continue
        if elapsed >= seconds:
            break
        timed()
    _sync(cuda)
    window_s = time.perf_counter() - t0 - paused
    return types.SimpleNamespace(
        window_s=window_s, units=len(unit_s), unit_s=unit_s, stretch=stretch,
        traced_from=traced_from, plain_units=len(unit_s) if stretch is None else traced_from,
        plain_s=window_s if stretch is None else plain_s)


def profile_stretch(timed, units: int, cuda: bool):
    """Runs timed() `units` times under the profiler, between two
    synchronises; returns the Stretch, whose reading is left until after the
    window."""
    from torch.profiler import profile

    spans = []
    with profile(activities=_activities(cuda)) as prof:
        _sync(cuda)
        t = time.perf_counter()
        lo = time.time_ns()
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        for _ in range(units):
            a = time.time_ns()
            timed()
            spans.append((a, time.time_ns()))
        if cuda:
            e1.record()
        _sync(cuda)
        hi = time.time_ns()
        units_s = time.perf_counter() - t
    return Stretch(prof, units, units_s, (lo, hi), spans, (e0, e1) if cuda else None)


class Stretch:
    """A traced stretch: `units_s`, the host time of its units from the
    synchronise before them to the one after; `bounds` and `spans`, the
    stretch's and each unit's host interval on the profiler's clock."""

    def __init__(self, prof, units, units_s, bounds, spans, events):
        self.prof, self.units, self.units_s = prof, units, units_s
        self.bounds, self.spans, self._events = bounds, spans, events

    def read(self):
        out = read(_events(self.prof), self.units, self.bounds, self.spans)
        out.units_s = self.units_s
        out.event_s = self._events[0].elapsed_time(self._events[1]) / 1e3 \
            if self._events else None
        return out


def _events(prof):
    """(host events, device events) as (start_ns, end_ns, name) lists."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (start, start + e.duration_ns(), e.name())
        (device if str(e.device_type()).endswith("CUDA") else host).append(item)
    return host, device


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_at(inner, starts, t: int) -> str:
    """The name of the innermost host event running at t (the latest that
    started at or before t and ends after it)."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if inner[i][1] > t:
            return inner[i][2]
    return HOST


def read(events, units: int, bounds, spans):
    """The stretch's length, busy time, kernels, top device operations, idle
    gaps by what the host was doing, the units' spans, the CUDA runtime
    calls and CUPTI's records of the host blocked (BLOCKED)."""
    host, device = events
    lo, hi = bounds
    clipped = sorted((max(a, lo), min(b, hi), n) for a, b, n in device if min(b, hi) > max(a, lo))
    busy = _union([(a, b) for a, b, _ in clipped])
    kernels = [(short_name(n), a, b - a) for a, b, n in clipped
               if not n.startswith(("Memcpy", "Memset"))]
    by_op = defaultdict(int)
    for a, b, n in clipped:
        by_op[short_name(n)] += b - a
    gaps, edge = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    inner = sorted(host)
    starts = [a for a, _, _ in inner]
    by_gap = defaultdict(int)
    for a, b in gaps:
        by_gap[_host_at(inner, starts, (a + b) // 2)] += b - a
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return types.SimpleNamespace(
        window_s=(hi - lo) / 1e9, busy_s=sum(b - a for a, b in busy) / 1e9, units=units,
        kernels=kernels, device_ops=top(by_op), idle_gaps=top(by_gap), spans=list(spans),
        runtime=sorted((a, b, n) for a, b, n in host if n.startswith(("cuda", "cu"))),
        blocked=sorted((a, b, n) for a, b, n in host if n in BLOCKED))
