"""Percent: the bound time of the traced steps' K4 and K5 calls (flash
attention forward and backward at the image tower's T = 257, work/k4.py and
work/k5.py) over the device time of their launches."""

from work.calls import roofline


def read(record):
    return roofline(record, ("k4", "k5"))
