"""The median over the traced batches of the device time of the kernels
launched inside the program's `preprocess` span: the resize GEMMs and the
elementwise passes of `preprocess_batch` (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "preprocess", "device_ms")
