"""Runtime helpers: a reliable sync, timing, profiling and device time.

A port of pointwise_tpu/utils/runtime.py.  PyTorch returns from a CUDA call
before the card has run it, so a host clock measures the enqueue unless the
card is synchronised first: ``sync`` and ``timed`` do that.  Device time
comes from ``torch.profiler`` (CUPTI): ``device_seconds`` is the union of
the device's busy intervals in a trace, the one rule every caller uses
(``profile_device_time``, ``StepWindow``, the tools in
pointwise_torch/tools and chip_smoke.py).  A union, not a sum: kernels on
two streams may overlap, and a sum would count that time twice.  When the
profiler sees no device time (the CPU, or a card it cannot trace) the
helpers say so (``None``, "not measured") instead of guessing.

``span`` names a phase of the program on the profiler's clock: the
streaming engine and the trainer open one around each phase, so that a
trace can put the device's idle time down to the phase that kept the host
busy.  It opens a profiler range only while a profiler runs.

``honor_platform_env`` and ``enable_compile_cache`` of the JAX module have
no counterpart: they work around the JAX platform plugin and its compile
cache, while the port's kernels are built once into kernels/_build/.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card they raise (``resolve_device``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, record_function

from pointwise_torch import resolve_device

# device-time families of a trace: (name, substring of the kernel name; a
# family may take two entries).  A walk family includes its feature-pack
# kernel (and dX's its scale kernel), dW's product its g-rounding kernel.
KERNEL_FAMILIES = (("fwd_walk", "FwdMeans"), ("fwd_product", "FwdProduct"),
                   ("dw_walk", "DwMeans"), ("dw_product", "DwProduct"),
                   ("dw_product", "pw_dw_product_pack"),
                   ("dw_reduce", "pw_dw_reduce"), ("dx_walk", "DxSums"),
                   ("dx_product", "DxProduct"),
                   ("counts", "pw_counts_kernel"))
NOT_MEASURED = "not measured"


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (its
    first line: the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> float:
    """Wait until the device of ``x`` has run everything queued on it, then
    fetch a scalar.  ``x``: a tensor, a (nested) list, tuple or dict of
    tensors (the first is used; none: 0.0) or a ``torch.device`` (0.0).
    Returns the f32 sum of the tensor."""
    if isinstance(x, torch.device):
        if x.type == "cuda":
            torch.cuda.synchronize(x)
        return 0.0
    t = _first_tensor(x)
    if t is None:
        return 0.0
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.detach().float().sum())


@contextlib.contextmanager
def timed(label: str, sink=None, device="cuda"):
    """Print (or pass to ``sink``) the wall ms of the block, the device
    synchronised at both ends."""
    dev = resolve_device(device)
    sync(dev)
    t0 = time.perf_counter()
    yield
    sync(dev)
    dt = time.perf_counter() - t0
    (sink or print)(f"# [{label}] {dt * 1e3:.1f} ms")


@contextlib.contextmanager
def span(name: str, into=None, key: str | None = None):
    """One phase of the program: adds the block's wall seconds to
    ``into[key]`` when ``into`` is given (a ``defaultdict(float)``), and
    while a profiler runs opens ``record_function(name)`` around it, so the
    phase lies on the trace's clock beside the kernels it launched.  With
    no profiler running it opens nothing (one check per use)."""
    t0 = time.perf_counter()
    if torch.autograd._profiler_enabled():
        with record_function(name):
            yield
    else:
        yield
    if into is not None:
        into[key] += time.perf_counter() - t0


def _activities(dev):
    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
            if dev.type == "cuda" else [ProfilerActivity.CPU])


@contextlib.contextmanager
def profile(logdir: str | None = None, device="cuda"):
    """``torch.profiler`` (CPU and, on the card, CUDA activities) around the
    block, the device synchronised before it stops; with ``logdir`` the
    trace is written to ``logdir/trace.json`` (chrome trace format).
    Yields the profiler."""
    dev = resolve_device(device)
    with torch.profiler.profile(activities=_activities(dev)) as prof:
        yield prof
        sync(dev)
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Card ms per call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup`` calls, then one synchronise."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(events):
    """The device events (kernels, copies, sets) among a trace's
    ``FunctionEvent``s.  User annotations drawn on the device's timeline
    (e.g. ``Optimizer.step#AdamW.step``) are spans over other events and
    the gaps between them, not device work, and are left out."""
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


def device_seconds(prof) -> float:
    """Seconds the device was busy in a profiler run: the union of its
    events' intervals (0.0 when it saw none)."""
    return interval_union_ns(
        _ns(e) for e in device_events(prof.events())) / 1e9


def device_ops(prof) -> dict:
    """{device event name: (seconds, calls)}, each event's own interval
    summed by name.  Their total is at most ``device_seconds`` when no two
    events overlap; the rest of a step is host time or bubbles."""
    ns, calls = collections.Counter(), collections.Counter()
    for e in device_events(prof.events()):
        a, b = _ns(e)
        ns[e.name] += b - a
        calls[e.name] += 1
    return {k: (v / 1e9, calls[k]) for k, v in ns.items()}


def family_seconds(ops: dict) -> dict:
    """``device_ops`` seconds rolled up by ``KERNEL_FAMILIES`` (and
    "other": every device op no family names)."""
    out = {fam: 0.0 for fam, _ in KERNEL_FAMILIES}
    out["other"] = 0.0
    for name, (s, _) in ops.items():
        fam = next((f for f, key in KERNEL_FAMILIES if key in name), "other")
        out[fam] += s
    return out


def top_ops(ops: dict, top: int, per: float = 1.0) -> list:
    """The ``top`` costliest ``device_ops``: name, ms and calls over
    ``per`` (steps or requests)."""
    return [{"op": k[:80], "ms": s * 1e3 / per, "calls": n / per}
            for k, (s, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])
            [:top]]


def profile_device_time(fn, iters: int = 4, device="cuda") -> float | None:
    """Device seconds per call of ``fn`` (called once before tracing, then
    ``iters`` times under the profiler), or None when the profiler saw no
    device time: an honest miss, never a host time in its place."""
    iters = max(1, int(iters))
    sync(fn())
    with profile(device=device) as prof:
        for _ in range(iters):
            fn()
    busy = device_seconds(prof)
    return busy / iters if busy > 0 else None


class StepWindow:
    """Times a run of steps as the JAX bench does (steps back to back, one
    sync at each end of the window) and traces the steps after it.

    Call ``window(step)`` after every step (numbered from 1): steps
    ``first + 1 .. last`` are the untraced window, ``last + 1 .. end`` run
    under the profiler.  ``summary()`` then gives ms per untraced step, the
    traced steps' device ms per step, the idle (host) share 1 - device ms /
    untraced ms, device ms per kernel family and the costliest device ops,
    or "not measured" where the profiler saw no device time."""

    def __init__(self, device, first: int, last: int, end: int):
        if not 1 <= first < last < end:
            raise ValueError(f"need 1 <= first < last < end, got {first}, "
                             f"{last}, {end}")
        self.device = resolve_device(device)
        self.first, self.last, self.end = first, last, end
        self.marks, self.prof = {}, None

    def __call__(self, step: int):
        if step in (self.first, self.last, self.end):
            sync(self.device)
            self.marks[step] = time.perf_counter()
        if step == self.last:
            self.prof = torch.profiler.profile(
                activities=_activities(self.device))
            self.prof.__enter__()
        elif step == self.end:
            self.prof.__exit__(None, None, None)

    def summary(self, top: int = 6) -> dict:
        if self.end not in self.marks:
            raise RuntimeError(f"the window ended before step {self.end}")
        untraced = ((self.marks[self.last] - self.marks[self.first])
                    / (self.last - self.first) * 1e3)
        traced = self.end - self.last
        out = dict(timed_steps=[self.first + 1, self.last],
                   ms_per_step=untraced,
                   traced_steps=[self.last + 1, self.end],
                   traced_ms_per_step=(self.marks[self.end]
                                       - self.marks[self.last])
                   / traced * 1e3)
        spans = [_ns(e) for e in device_events(self.prof.events())]
        busy_ns = interval_union_ns(spans)
        if busy_ns <= 0:
            out["device_ms_per_step"] = NOT_MEASURED
            return out
        ops = device_ops(self.prof)
        # both totals in integer ns, so the ops' sum exceeds the busy time
        # only where events overlap, never by the rounding of a float sum
        dev_ms = busy_ns / 1e6 / traced
        out.update(
            device_ms_per_step=dev_ms,
            device_idle_share=1.0 - dev_ms / untraced,
            op_ms_per_step=sum(b - a for a, b in spans) / 1e6 / traced,
            kernel_ms_per_step={k: v * 1e3 / traced for k, v in
                                family_seconds(ops).items()},
            top=top_ops(ops, top, per=traced))
        return out
