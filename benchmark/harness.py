"""What every cell shares: the benchmark's files found by name, the run's
record, the metric readers, the correctness checks and the result line.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(its file under `configs/`, listed in BENCHMARK.json) and a traffic mix
(`traffic/<name>.json`), whose `loop` names the code that drives the
window (`loops/<loop>.py`). Each metric is read by `metrics/<name>.py`, and the
limits of the cell's correctness checks are in `limits/<workload>.json`. A
new cell, configuration or metric is new files and entries; no file changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "construction_clip_tpu")


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path):
    """The module of a file, imported under a name of its own."""
    name = "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    limits and metrics, all found by name under `root` and `bench`."""

    def __init__(self, name: str, root: Path = ROOT, bench: Path = BENCH):
        self.root, self.bench = Path(root), Path(bench)
        spec = load_json(self.root / "BENCHMARK.json")
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        config = [c for c in spec["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(self.root / config["file"])
        self.traffic = load_json(self.bench / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(self.bench / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def loop(self):
        return load_module(self.bench / "loops" / f"{self.traffic['loop']}.py")

    def read_metrics(self, record, trace: bool) -> dict:
        """{name: {"value", "unit"}} of the cell's end-to-end metrics (trace 0)
        or per-layer metrics (trace 1); a reader that finds nothing to read
        returns None and its metric is left out."""
        out = {}
        for m in self.per_layer if trace else self.end_to_end:
            value = load_module(self.bench / "metrics" / f"{m['name']}.py").read(record)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number compared with its
    limit; a number that is missing or not finite fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value if value is None or math.isfinite(value) else str(value),
                        "limit": limit}
    return correct, checks


def clip_config(cfg: dict):
    """The program's CLIPConfig of a configuration file."""
    from construction_clip_tpu_torch.core.configs import CLIPConfig, TextConfig, VisionConfig

    return CLIPConfig(vision=VisionConfig(**cfg["vision"]), text=TextConfig(**cfg["text"]),
                      quick_gelu=cfg["quick_gelu"], logit_scale_init=cfg["logit_scale_init"])


def reference_module(cfg: dict):
    """The plain reference that a configuration names."""
    return load_module(BENCH / "reference" / f"{cfg['reference']}.py")


def sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def free_cuda(cuda: bool) -> None:
    """Returns the caching allocator's free blocks to the card."""
    if cuda:
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Clock:
    """Seconds of each part of set-up, each closed by a synchronise."""

    def __init__(self, cuda: bool):
        import time

        self._time, self.cuda, self.laps = time.perf_counter, cuda, []
        self._last = self._time()

    def lap(self, what: str) -> None:
        sync(self.cuda)
        now = self._time()
        self.laps.append((what, round(now - self._last, 3)))
        self._last = now

    def report(self) -> None:
        say("set-up parts (s)", dict(self.laps))


def forbidden_modules() -> list[str]:
    """Modules of jax, jaxlib, flax or the JAX package in this process,
    compared by whole top-level names."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
