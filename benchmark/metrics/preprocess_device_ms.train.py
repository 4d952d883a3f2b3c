"""The median over the traced steps of the device time of the kernels
launched inside the program's `preprocess` span: `preprocess_batch` on the
step's batch, already on the card (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "preprocess", "device_ms")
