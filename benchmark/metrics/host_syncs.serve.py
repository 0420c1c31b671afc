"""The program's calls that blocked the host on the card per scan of the
window (the engine's ``host_syncs`` event: the increase of the op
layer's ``HOST_SYNCS`` over the call), in syncs."""

from benchmark.metrics.program_spans import engine_event_mean


def read(rec):
    return engine_event_mean(rec, "host_syncs")
