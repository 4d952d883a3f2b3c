"""Runs one cell of BENCHMARK.json once and prints its result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell asks
for. Set-up (from the process's start to the window's) makes the inputs and
weights from the seed, builds the program's objects and warms the cell's
shapes; the window drives the program for --seconds and closes with a
synchronise. With --trace 0 the metrics are the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, read from a stretch of whole batches or
steps traced by torch.profiler in the middle of the window. After the window
the program's state is freed and the plain reference checks its outputs.
The last line of standard output is the result, as JSON; the numbers compared
are also the last lines of standard error. Without the CUDA devices the cell
asks for, or with the JAX package or JAX loaded after the window, the run
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent)) if p not in sys.path]

import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(cuda: bool) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_once(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, t0: float):
    """Set-up and window of one run: (the loop's run, the window's record)."""
    harness.say("set-up parts (s)",
                {"process start, imports, CUDA": round(time.perf_counter() - t0, 3)})
    run = cell.loop().Run(cell.config, cell.traffic, seed, device, trace)
    t_window = time.perf_counter()
    record = run.window(seconds, trace)
    record.setup_s = t_window - t0
    return run, record


def main(argv=None, *, root: Path = harness.ROOT, bench: Path = BENCH, need_cuda: bool = True,
         t0: float = T0) -> int:
    args = parse_args(argv)
    cell = harness.Cell(args.workload, root, bench)
    import torch

    if need_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        harness.say(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cuda = need_cuda
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        harness.say("device", torch.cuda.get_device_name(0), "|", power_limit(), "| torch",
                    torch.__version__, "cuda", torch.version.cuda)
        harness.say("kernel cache", "warm" if _built(root) else "cold (this run builds it)")
    run, record = run_once(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    memory_peak = run.memory_peak
    metrics = cell.read_metrics(record, bool(args.trace))
    info = device_info(cuda)
    info["memory_peak_bytes"] = int(memory_peak)
    breakdown = None
    if args.trace and record.trace is not None:
        tr = record.trace
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        describe_trace(record)
    harness.say("window", f"{record.window_s:.6f} s", f"units {record.units}",
                f"set-up {record.setup_s:.3f} s")
    t_check = time.perf_counter()
    readings = run.check()
    correct, checks = harness.judge(readings, cell.limits)
    harness.say("check", f"{time.perf_counter() - t_check:.3f} s", "readings", readings)
    found = harness.forbidden_modules()
    if found:
        harness.say("loaded after the window, which the benchmark forbids:", ", ".join(found))
        return 3
    print(harness.result_line(correct, record.units, 0, metrics, info, checks, breakdown),
          flush=True)
    for name, c in checks.items():
        harness.say(f"compared {name} {c['value']} limit {c['limit']}")
    return 0


def describe_trace(record) -> None:
    """The traced stretch on standard error: its clocks, idle share,
    launches, runtime calls and device time by kind, and the units' host
    times before, in and after it."""
    from work.calls import by_kind, launch_table

    tr = record.trace
    harness.say("stretch", f"units {tr.units}", f"profiler window {tr.window_s:.6f} s",
                f"busy {tr.busy_s:.6f} s", f"CUDA events {tr.event_s} s",
                f"units' host time {tr.units_s:.6f} s")
    harness.say("idle share % of the traced stretch", 100 * (1 - tr.busy_s / tr.window_s))
    if getattr(record, "calls", None):
        harness.say("launches", launch_table(record))
    calls: dict = {}
    for a, b, n in tr.runtime + tr.blocked:
        calls.setdefault(n, []).append((b - a) / 1e3)
    harness.say("runtime calls and blocked host a unit [count, ms, median us]",
                {n: [round(len(d) / tr.units, 3), round(sum(d) / 1e3 / tr.units, 3),
                     round(statistics.median(d), 3)] for n, d in calls.items()})
    harness.say("device ms a unit by kind", by_kind(record))
    if record.traced_from:
        ms = [t * 1e3 for t in record.unit_s]
        before, after = ms[:record.traced_from], ms[record.traced_from + tr.units:]
        harness.say("unit ms medians: before the stretch", statistics.median(before),
                    "in it", statistics.median(ms[record.traced_from:][:tr.units]),
                    "after it", statistics.median(after) if after else None)


def _built(root: Path) -> bool:
    return any((root / "build" / "torch_kernels").glob("libcct_*.so"))


if __name__ == "__main__":
    sys.exit(main())
