"""The streaming engine's planning per scan of the window (its
``engine.plan`` span, the ``plan_s`` event): grouping the tiles,
coalescing their schedules, matching the length profiles, uploading the
resident scene and allocating the output, between the schedule build and
the packer's start, in ms."""

from benchmark.metrics.program_spans import engine_event_mean


def read(rec):
    v = engine_event_mean(rec, "plan_s")
    return None if v is None else 1e3 * v
