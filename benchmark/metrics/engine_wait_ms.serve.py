"""The streaming engine's wait for its packer thread per scan of the
window (its ``engine.wait_packer`` span, the ``wait_packer_s`` event):
time the dispatch loop had no packed chunk to stage, in ms."""

from benchmark.metrics.program_spans import engine_event_mean


def read(rec):
    v = engine_event_mean(rec, "wait_packer_s")
    return None if v is None else 1e3 * v
