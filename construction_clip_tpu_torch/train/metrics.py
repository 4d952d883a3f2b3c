"""Training observability (the port's copy of MetricLogger and StepTimer from
construction_clip_tpu/train/metrics.py).

  - MetricLogger writes host-side scalars as JSONL (always) and as TensorBoard
    event files when `torch.utils.tensorboard` or `tensorboardX` imports;
  - StepTimer is a rolling step-time meter on the host clock.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._jsonl = open(self.jsonl_path, "a", encoding="utf-8")
        self._tb = None
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            try:
                writer_mod = importlib.import_module(mod)
                self._tb = writer_mod.SummaryWriter(log_dir=os.path.join(log_dir, run_name))
                break
            except Exception:  # noqa: BLE001 — an optional writer that does not import
                continue

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Rolling step-time / throughput meter."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def per_second(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.mean else 0.0
