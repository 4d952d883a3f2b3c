"""The median over the traced steps of the kernel launch calls made inside
the program's `optimizer` span: AdamW's `_foreach_*` passes, which launch by
chunks of leaves (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "optimizer", "launches")
