"""Device busy time from a ``torch.profiler`` run: the union of the
device's busy intervals.

Copied from pointwise_torch/utils/runtime.py at commit 79480e8
(``device_events``, ``_ns``, ``interval_union_ns``).
"""

from __future__ import annotations

import torch


def device_events(events):
    """The device events (kernels, copies, sets) among a trace's
    ``FunctionEvent``s.  User annotations drawn on the device's timeline
    are spans over other events and the gaps between them, not device
    work, and are left out."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _ns(e):
    """(start, end) of an event in integer ns (exact sums)."""
    return round(e.time_range.start * 1e3), round(e.time_range.end * 1e3)


def interval_union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total
