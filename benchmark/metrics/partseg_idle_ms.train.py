"""The device's idle time under the part segmenter's own spans
(``partseg.*``: the global pool, the category's embedding and their
broadcast beside the skips; the head and ``out``), the gaps whose
innermost open host range is one of them and no operation inside it, per
traced step, in ms.  None on a program without those spans."""

from benchmark.metrics.program_spans import idle_under_ms


def read(rec):
    return idle_under_ms(rec, "train", "partseg.")
