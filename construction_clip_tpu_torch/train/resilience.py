"""Crash-resumable training (counterpart of construction_clip_tpu/train/resilience.py's
`run_resilient`, and a copy of its `StepWatchdog`).

`StepWatchdog` logs (or calls back) when no step has completed for `timeout`
seconds. `run_resilient` drives an epoch function with periodic snapshots through the
port's checkpoint module, and on an exception restores the latest snapshot and
retries (bounded). AdamW updates the params and moments in place, so a state
caught in the middle of an epoch is neither the state before it nor after it:
only states at epoch boundaries are ever saved, and the one before the first
epoch is saved too, so that a failure before the first periodic snapshot has a
state to return to. Data-parallel (`dp`), rank 0 writes the snapshots and
every rank restores from them (train/checkpoint.py); a rank whose epoch
raises while the others go on leaves them waiting in the step's next
collective, which the watchdog reports as a stall.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Optional

from construction_clip_tpu_torch.train.checkpoint import latest_step, restore_state, save_state


class StepWatchdog:
    """Background monitor: call .tick() per completed step; if no tick arrives for
    `timeout` seconds, `on_stall(seconds_since_progress)` fires (once per stall)."""

    def __init__(self, timeout: float = 300.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll: float = 5.0):
        self.timeout = timeout
        self.on_stall = on_stall or (lambda dt: print(
            f"[watchdog] no step progress for {dt:.0f}s — device stall suspected",
            flush=True))
        self.poll = poll
        self._last = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def tick(self) -> None:
        self._last = time.monotonic()
        self._stalled = False

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            dt = time.monotonic() - self._last
            if dt > self.timeout and not self._stalled:
                self._stalled = True
                self.stall_count += 1
                try:
                    self.on_stall(dt)
                except Exception:  # noqa: BLE001 — the monitor thread keeps running
                    traceback.print_exc()

    def __enter__(self) -> "StepWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.poll + 1)


def run_resilient(train_epoch: Callable, state, *, epochs: int, checkpoint_dir: str,
                  save_every_epochs: int = 1, max_retries: int = 3,
                  on_retry: Optional[Callable[[int, Exception], None]] = None, dp=None):
    """Run `train_epoch(state, epoch) -> state` for `epochs`, checkpointing the
    state before the first epoch, every `save_every_epochs` and after the last;
    on exception, restore the latest checkpoint and retry (up to max_retries
    consecutive failures). A checkpoint is named by the number of epochs done.
    A KeyboardInterrupt saves nothing (the state is mid-epoch) and propagates.
    Returns the final state."""
    start_epoch = latest_step(checkpoint_dir)
    if dp is not None:
        dp.barrier()   # every rank has looked before rank 0 writes step 0
    if start_epoch is None:
        start_epoch = save_state(checkpoint_dir, state, step=0, dp=dp)
    else:
        state = restore_state(checkpoint_dir, state)
        print(f"[resilience] resumed from epoch {start_epoch}")

    retries = 0
    epoch = start_epoch
    while epoch < epochs:
        try:
            state = train_epoch(state, epoch)
            retries = 0
            if (epoch + 1) % save_every_epochs == 0 or epoch == epochs - 1:
                save_state(checkpoint_dir, state, step=epoch + 1, dp=dp)
            epoch += 1
        except Exception as e:  # noqa: BLE001 — deliberate: retry any epoch failure
            retries += 1
            if on_retry:
                on_retry(retries, e)
            print(f"[resilience] epoch {epoch} failed ({type(e).__name__}: {e}); "
                  f"retry {retries}/{max_retries}")
            if retries > max_retries:
                raise
            epoch = latest_step(checkpoint_dir)
            state = restore_state(checkpoint_dir, state, step=epoch)
    return state
