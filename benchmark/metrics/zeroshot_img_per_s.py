"""Images classified in the window over the window's wall time, which ends
in a synchronise (host clock)."""


def read(record):
    return record.done / record.window_s
