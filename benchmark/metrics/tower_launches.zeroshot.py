"""The median over the traced batches of the kernel launch calls made inside
the program's `tower.image` span, a `cuLaunchKernel*` call inside a
`cudaLaunchKernel*` call counted once (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "tower.image", "launches")
