"""GiB: the most memory the caching allocator held for tensors during the
window (torch.cuda.max_memory_allocated after reset_peak_memory_stats at
the window's start)."""


def read(record):
    return record.peak_window_bytes / 2 ** 30 if record.peak_window_bytes else None
