"""Percent of a batch's wall time in which no operation ran on the card, as
a user's untraced run sees it: one less the device's busy time a batch (the
union of the traced stretch's device intervals, clipped to it) over the wall
time a batch of the window's batchs before the stretch, which the profiler
has not slowed. The stretch's own idle share, which the profiler's cost on
the host inflates, follows from the result's busy_s and window_s."""


def read(record):
    tr = record.trace
    if tr is None or tr.busy_s <= 0 or not tr.kernels or not record.plain_units:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.units) / (record.plain_s / record.plain_units))
