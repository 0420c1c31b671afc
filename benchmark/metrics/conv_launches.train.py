"""Launches of the program's conv kernels (the op layer's ``LAUNCHES``
counters, every walk, product and counts kernel) per step of the window."""


def read(rec):
    if rec["kind"] != "train":
        return None
    n = rec["steps"]
    return sum(rec["launches"].values()) / n if n else None
