"""The 95th percentile (linear interpolation) of every window batch's host
time from the call of the app's batch function, with its staged uint8 array,
to the return of its labels on the host."""

import numpy as np


def read(record):
    if not record.latencies:
        return None
    return float(np.percentile(np.asarray(record.latencies), 95)) * 1e3
