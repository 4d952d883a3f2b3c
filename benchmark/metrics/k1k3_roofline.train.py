"""Percent: the bound time of the traced steps' K1 and K3 calls (the fused
block's forward and backward at the towers whose sequences take it,
work/k1.py and work/k3.py) over the device time of their launches."""

from work.calls import roofline


def read(record):
    return roofline(record, ("k1", "k3"))
