"""The streaming engine's fetch of each chunk's logits to the host per
scan of the window (its ``engine.fetch`` span, the ``flush_fetch_s``
event): the wait for the card's chunk and the copy, in ms."""

from benchmark.metrics.program_spans import engine_event_mean


def read(rec):
    v = engine_event_mean(rec, "flush_fetch_s")
    return None if v is None else 1e3 * v
