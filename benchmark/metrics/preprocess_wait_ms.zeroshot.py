"""The median over the traced batches of the time the host was blocked
inside the program's `preprocess` span: the pageable copies of the batch and
of the resize tables, mean and std, each waiting for the card's earlier work
(work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "preprocess", "wait_ms")
