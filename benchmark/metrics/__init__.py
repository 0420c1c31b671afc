"""One reader per metric, found by the metric's name: ``<name>.py`` here
defines ``read(rec)``, which returns the metric's value from a run's
record (benchmark/serve.py, benchmark/train.py) or None when the record
has nothing for it, and the harness then leaves the metric out.  The
arithmetic that a serving and a training reader share is below, each
taking the record and the loop ``kind`` it reads."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def conv_roofline(rec, kind: str):
    """The least time of the traced scans' or steps' conv calls
    (benchmark/work.py) over the device time of the program's conv
    kernels in them, in percent.  The kernels are the device operations
    whose names hold one of the patterns of conv_kernels.json; where none
    does, the metric is left out."""
    if rec["kind"] != kind or "trace" not in rec or "work" not in rec:
        return None
    with open(os.path.join(HERE, "conv_kernels.json")) as f:
        patterns = json.load(f)["kernel_name_patterns"]
    secs = sum(s for name, s in rec["trace"]["ops"].items()
               if any(p in name for p in patterns))
    if secs <= 0:
        print(f"conv_roofline.{kind}: no device operation matched "
              f"{patterns}", file=sys.stderr)
        return None
    return 100.0 * rec["work"]["traced_conv_least_s"] / secs


def mfu(rec, kind: str):
    """Useful operations completed in the window (benchmark/work.py, from
    the harness's own in-ball pair counts) over the window's seconds times
    the H100's dense bf16 peak, in percent."""
    from benchmark.work import PEAK_BF16_FLOPS

    if rec["kind"] != kind or "work" not in rec:
        return None
    return 100.0 * rec["work"]["window_ops"] / (rec["window_s"]
                                                * PEAK_BF16_FLOPS)


def device_idle(rec, kind: str):
    """1 - the union of the device's busy intervals over the host seconds
    of the traced scans or steps, in percent."""
    if rec["kind"] != kind or "trace" not in rec:
        return None
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
