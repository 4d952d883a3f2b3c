"""The median over the traced steps of the host's own time in a step: the
step's span, from the call that copies its batch to the card to its return
(with the loss read every log_every steps), less the time the host spent
blocked on the card inside it. It blocks in copies and synchronising calls
(`preprocess_batch` copies its tables from pageable memory, which waits for
the previous step's work), and where CUPTI records it blocked: on a full
launch queue ("Command Buffer Full") or on the profiler's own buffers.
Read from the CUDA runtime calls in the profiler's trace."""

import statistics

WAIT = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(record):
    tr = record.trace
    if tr is None or not tr.runtime or not tr.spans:
        return None
    blocks = [(a, b) for a, b, n in tr.runtime if n.startswith(WAIT)]
    blocks += [(a, b) for a, b, _ in tr.blocked]
    out = []
    for lo, hi in tr.spans:
        inside = sorted((max(a, lo), min(b, hi)) for a, b in blocks if min(b, hi) > max(a, lo))
        blocked, edge = 0, lo
        for a, b in inside:
            blocked += max(0, b - max(a, edge))
            edge = max(edge, b)
        out.append((hi - lo - blocked) / 1e6)
    return statistics.median(out)
