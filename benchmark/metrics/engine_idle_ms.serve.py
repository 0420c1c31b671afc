"""The device's idle time under the streaming engine's own spans
(``engine.*``: the gaps whose innermost open host range is a phase of the
engine and no operation inside it) per traced scan, in ms."""

from benchmark.metrics.program_spans import idle_under_ms


def read(rec):
    return idle_under_ms(rec, "serve", "engine.")
