"""The 4096-point chunks the voting path runs through the net per room of
the window (its ``chunks`` event, the rows ``room_blocks`` emits; the rows
that pad the last batch are not counted): a guard on the amplification
of the points, about 16 windows each at a 0.25 m stride."""

from benchmark.metrics.vote_events import vote_event_mean


def read(rec):
    return vote_event_mean(rec, "chunks")
