"""Percent of the card's float32 peak (67 TFLOP/s, outside the tensor cores):
the image tower's model FLOPs (work/model.py) of the window's batches before
the traced stretch over their wall time: the profiler slows the host that
paces this cell, also after it stops, and these batches are as a user runs
them."""

from peaks import OPS_PER_S
from work import model


def read(record):
    t = record.traffic
    if not record.plain_units:
        return None
    flops = record.plain_units * model.zeroshot_batch(record.cfg, t["batch"], t["labels"])
    return 100.0 * flops / record.plain_s / OPS_PER_S[t["precision"]]
