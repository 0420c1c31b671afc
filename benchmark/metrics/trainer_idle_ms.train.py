"""The device's idle time under the trainer's own spans (``train.*``:
forward, backward, clip and optimizer, the gaps whose innermost open host
range is one of them and no operation inside it) per traced step, in
ms."""

from benchmark.metrics.program_spans import idle_under_ms


def read(rec):
    return idle_under_ms(rec, "train", "train.")
