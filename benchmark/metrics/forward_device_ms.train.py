"""The median over the traced steps of the device time of the kernels
launched inside the program's `forward` span (`train/contrastive.loss_and_grads`:
both towers, the casts to the compute type, InfoNCE and the accuracy)
(work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "forward", "device_ms")
