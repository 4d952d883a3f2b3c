"""The median over the traced batches of the host's own time in the
program's `preprocess` span (`data/preprocess.preprocess_batch`: the uint8
copy to the card, the resize tables, the einsums, crop and normalize): the
span less the time blocked in copies and synchronises inside it
(work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "preprocess", "host_ms")
