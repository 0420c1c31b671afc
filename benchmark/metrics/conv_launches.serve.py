"""Launches of the program's conv kernels (the op layer's ``LAUNCHES``
counters, every walk, product and counts kernel) per scan of the window."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    n = len(rec["requests"])
    return sum(rec["launches"].values()) / n if n else None
