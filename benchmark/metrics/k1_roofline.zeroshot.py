"""Percent: the bound time of the traced batches' K1 calls (the image tower's
fused block forward, work/k1.py) over the device time of the launches that
implement them."""

from work.calls import roofline


def read(record):
    return roofline(record, ("k1",))
