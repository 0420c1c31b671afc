"""Seconds from the process's start to the window's: imports, the card's
context, loading the built kernels (building them on a checkout's first
run), inputs, weights and the warm-up requests or steps."""


def read(rec):
    return rec["setup_s"]
