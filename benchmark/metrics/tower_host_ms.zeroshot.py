"""The median over the traced batches of the host's own time in the
program's `tower.image` span (`models/clip/model.encode_image`: the cast of
the params, patch embedding, the block stack, the projection), less the time
blocked inside it: the cost of issuing the image tower's launches
(work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "tower.image", "host_ms")
