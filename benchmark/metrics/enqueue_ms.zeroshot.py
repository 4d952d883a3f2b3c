"""The median over the traced stretch's batches of the host's time from the
call of the app's batch function to the start of its first blocking copy or
synchronise after its last kernel launch (where it begins to wait for the
card), read from the CUDA runtime calls in the profiler's trace."""

import statistics

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx")
WAIT = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(record):
    tr = record.trace
    if tr is None or not tr.runtime or not tr.spans:
        return None
    out = []
    for lo, hi in tr.spans:
        calls = [(a, n) for a, _, n in tr.runtime if lo <= a < hi]
        launches = [a for a, n in calls if n.startswith(LAUNCH)]
        if not launches:
            continue
        waits = [a for a, n in calls if n.startswith(WAIT) and a > launches[-1]]
        if waits:
            out.append((waits[0] - lo) / 1e6)
    return statistics.median(out) if out else None
