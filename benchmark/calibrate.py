"""Readings that the correctness limits of a cell are set from, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--controls 4,5,6] [--seconds 2] [--out file.jsonl]

For each seed of --seeds, the program's numbers as a run of the cell reads
them (set-up, a window of --seconds, the check against the fp32 reference).
For each seed of --controls, also the control's, the reference one precision
below the configuration's put in the program's place (TF32 for the fp32
zero-shot cell, float8 for the bf16 training cells), and each fault of
faults.py that the cell can have, planted in the program. One JSON line a
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent)) if p not in sys.path]

import faults  # noqa: E402
import harness  # noqa: E402
from run import run_once  # noqa: E402

CONTROL = {"fp32": "tf32", "bf16": "fp8"}
CELL_FAULTS = {"zeroshot": ("altered_answer",), "train": ("half_batch", "unchanged_state")}


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    out = {"seed": seed}
    run, record = run_once(cell, seed, seconds, False, device, time.perf_counter())
    out["units"] = record.units
    out["program"] = run.check()
    if control:
        out["control"] = run.control(CONTROL[cell.traffic["precision"]])
        for name in CELL_FAULTS[run.kind]:
            with faults.FAULTS[name]():
                bad, _ = run_once(cell, seed, seconds, False, device, time.perf_counter())
                if run.kind == "zeroshot":
                    out[name] = bad.check()
                else:   # the training readings against this seed's reference
                    bad.free()
                    out[name] = bad.readings(bad.program, run.want)
            del bad
            gc.collect()
    del run
    gc.collect()
    harness.free_cuda(device.type == "cuda")
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        harness.say("calibrate needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    seeds = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.controls.split(",") if s]
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for seed, control in seeds:
            t = time.perf_counter()
            line = readings(cell, seed, args.seconds, device, control)
            line.update(workload=args.workload, seconds=time.perf_counter() - t)
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
