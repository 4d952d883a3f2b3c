"""The median over the traced steps of the device time of the kernels
launched inside the program's `backward` span (`train/contrastive.loss_and_grads`:
autograd's backward, whose launches come from its device thread while the
step's thread waits in the span) (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "backward", "device_ms")
