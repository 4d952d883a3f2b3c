"""Percent of the card's peak in the step's precision (989 TFLOP/s bf16): both
towers' model FLOPs, forward and backward (work/model.py), of the window's
steps before the traced stretch over their wall time, up to a synchronise:
the profiler slows the host, also after it stops, and these steps are as a
user runs them."""

from peaks import OPS_PER_S
from work import model


def read(record):
    t = record.traffic
    if not record.plain_units:
        return None
    flops = record.plain_units * model.train_step(record.cfg, t["batch"])
    return 100.0 * flops / record.plain_s / OPS_PER_S[t["precision"]]
