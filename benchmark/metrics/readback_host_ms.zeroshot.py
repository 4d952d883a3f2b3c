"""The median over the traced batches of the host's own time in the
program's `readback` span (`apps/predict_zeroshot.make_process`: from the
probabilities' copy to the host to the returned records), less the copies'
waits: time in which the card idles in a closed loop (work/spans.py)."""

from work import spans


def read(record):
    return spans.median(record, "readback", "host_ms")
