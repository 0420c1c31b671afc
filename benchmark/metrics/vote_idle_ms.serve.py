"""The device's idle time under the voting path's own spans (``vote.*``:
crop, forward with its fetch, scatter; the gaps whose innermost open host
range is one of them and no operation inside it) per traced room, in ms.
None on a program without those spans."""

from benchmark.metrics.program_spans import idle_under_ms


def read(rec):
    return idle_under_ms(rec, "serve", "vote.")
