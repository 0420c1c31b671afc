"""The window's share of the H100's dense bf16 peak in a training cell, in percent
(benchmark/metrics/__init__.py, ``mfu``)."""

from benchmark.metrics import mfu


def read(rec):
    return mfu(rec, "train")
