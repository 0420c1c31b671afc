"""The conv kernels' share of their roofline in a serving cell, in percent
(benchmark/metrics/__init__.py, ``conv_roofline``)."""

from benchmark.metrics import conv_roofline


def read(rec):
    return conv_roofline(rec, "serve")
