"""The program's own spans in a traced stretch (`core/tracing.py` of the
port), and what each covers of the stretch's trace: its host time less the
time it was blocked, its kernel launch calls, and the device time of the
kernels those calls launched.

The program records spans only while a profiler session is active, stamped
with the profiler's clock. Those that lie between the first unit span's
start and the last one's end (`record.trace.spans`) are read, each in the
unit in which it starts.

A span's kernels are those whose launch call started while it was open, on
any thread: autograd's device thread launches the backward's kernels while
the step's thread waits inside `backward`, and a nested span's kernels are
its parent's too. The stretch's launch calls are matched one to one, in
order, to its kernels (`record.trace.kernels`): the stretch opens and closes
with a synchronise, and every cell runs on one stream. A `cuLaunchKernel*`
call whose interval lies inside a `cudaLaunchKernel*` call is the same
launch and counts once. Where the two counts still differ, no device time
is given.

Blocked time is as `metrics/enqueue_ms.train.py` reads it: the runtime's
copies and synchronises, and CUPTI's records of the host blocked
(`record.trace.blocked`), their union clipped to the span.

Without a trace, a program that records no spans (a checkout older than
`core/tracing.py`) or the CUDA runtime's calls (a run on the CPU), every
reading is None.
"""

from __future__ import annotations

import bisect
import statistics

RUNTIME_LAUNCH = "cudaLaunchKernel"   # also cudaLaunchKernelExC
CU_LAUNCH = "cuLaunchKernel"          # also cuLaunchKernelEx
WAIT = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def program_spans(lo: int, hi: int) -> list | None:
    """The program's spans that lie within [lo, hi]; None where the program
    has no span recorder."""
    try:
        from construction_clip_tpu_torch.core import tracing
    except ImportError:
        return None
    return [s for s in tracing.spans(lo, hi) if lo <= s.start_ns and s.end_ns <= hi]


def launch_calls(runtime) -> list:
    """The start times of the kernel launch calls among the runtime calls
    [(start, end, name)], in order; a `cuLaunchKernel*` call inside a
    `cudaLaunchKernel*` call is left out."""
    outer = sorted((a, b) for a, b, n in runtime if n.startswith(RUNTIME_LAUNCH))
    starts = [a for a, _ in outer]
    out = [a for a, _ in outer]
    for a, b, n in runtime:
        if not n.startswith(CU_LAUNCH):
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or outer[i][1] < b:
            out.append(a)
    return sorted(out)


def _blocked_ns(lo: int, hi: int, blocks) -> int:
    inside = sorted((max(a, lo), min(b, hi)) for a, b in blocks if min(b, hi) > max(a, lo))
    blocked, edge = 0, lo
    for a, b in inside:
        blocked += max(0, b - max(a, edge))
        edge = max(edge, b)
    return blocked


def units(record) -> list | None:
    """[{span name: {"host_ms", "wait_ms", "launches", "device_ms"}}], one
    dict a unit of the traced stretch: a span's host time less blocked, its
    blocked time, its launch calls and its kernels' device time (None where
    launches and kernels do not match), summed over the unit's spans of that
    name. None where there is nothing to read."""
    tr = getattr(record, "trace", None)
    if tr is None or not tr.runtime or not tr.spans:
        return None
    unit_starts = [a for a, _ in tr.spans]
    lo, hi = unit_starts[0], tr.spans[-1][1]
    found = program_spans(lo, hi)
    if not found:
        return None
    launches = [a for a in launch_calls(tr.runtime) if lo <= a <= hi]
    durations = [dur for _, _, dur in tr.kernels] if len(launches) == len(tr.kernels) else None
    blocks = [(a, b) for a, b, n in tr.runtime if n.startswith(WAIT)]
    blocks += [(a, b) for a, b, _ in tr.blocked]
    out = [{} for _ in tr.spans]
    for s in found:
        i, j = bisect.bisect_left(launches, s.start_ns), bisect.bisect_left(launches, s.end_ns)
        blocked = _blocked_ns(s.start_ns, s.end_ns, blocks)
        unit = out[bisect.bisect_right(unit_starts, s.start_ns) - 1]
        got = unit.setdefault(s.name, {"host_ms": 0.0, "wait_ms": 0.0, "launches": 0,
                                       "device_ms": None if durations is None else 0.0})
        got["host_ms"] += (s.end_ns - s.start_ns - blocked) / 1e6
        got["wait_ms"] += blocked / 1e6
        got["launches"] += j - i
        if durations is not None:
            got["device_ms"] += sum(durations[i:j]) / 1e6
    return out


def median(record, name: str, field: str) -> float | None:
    """The median over the stretch's units that hold a span `name` of its
    `field` ("host_ms", "wait_ms", "launches" or "device_ms"); None where no
    unit holds one or the field was not read."""
    read = units(record)
    values = [u[name][field] for u in read or () if name in u]
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)
