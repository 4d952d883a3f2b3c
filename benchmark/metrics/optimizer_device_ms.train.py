"""The median over the traced steps of the device time of the kernels
launched inside the program's `optimizer` span (`train/state.apply_gradients`:
AdamW's `_foreach_*` passes over the leaves, the parameters updated in
place) (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "optimizer", "device_ms")
