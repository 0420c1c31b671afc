"""The traced part of a run: a few requests or steps under
``torch.profiler`` after the window, reduced to device busy time, the
device's operations by name and its idle gaps by what the host was doing.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from benchmark.frozen.runtime import _ns, device_events, interval_union_ns

# idle gaps attributed to a host operation, longest first
_GAPS_ATTRIBUTED = 2000


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def traced(fn, n: int, device) -> dict:
    """Run ``fn(i)`` for i < n under the profiler, the device synchronised
    at both ends.  Returns busy_s (the union of the device's busy
    intervals), window_s (host seconds of the traced calls), ops {device
    op name: seconds}, gaps {host op name: idle seconds} and n."""
    dev = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        sync(dev)
        window = time.perf_counter() - t0
    events = prof.events()
    spans = [_ns(e) for e in device_events(events)]
    ops = collections.Counter()
    for e, (a, b) in zip(device_events(events), spans):
        ops[e.name] += (b - a) / 1e9
    return dict(busy_s=interval_union_ns(spans) / 1e9, window_s=window,
                ops=dict(ops), gaps=_idle_gaps(spans, events), n=n)


def _idle_gaps(spans, events) -> dict:
    """{innermost host op around the gap's middle: idle seconds} over the
    gaps between the device's merged busy intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    starts = np.array([_ns(e)[0] for e in host], np.int64)
    ends = np.array([_ns(e)[1] for e in host], np.int64)
    out = collections.Counter()
    for a, b in gaps[:_GAPS_ATTRIBUTED]:
        mid = (a + b) // 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("host outside any traced op" if len(inside) == 0
                else host[inside[np.argmax(starts[inside])]].name)
        out[name] += (b - a) / 1e9
    return dict(out)


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
