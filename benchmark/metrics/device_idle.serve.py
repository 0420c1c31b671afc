"""The device's idle share in a serving cell, in percent
(benchmark/metrics/__init__.py, ``device_idle``)."""

from benchmark.metrics import device_idle


def read(rec):
    return device_idle(rec, "serve")
