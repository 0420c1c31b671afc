"""The voting path's crop of a room into chunks (its ``vote.crop`` span,
the ``crop_s`` event: ``room_blocks`` over every window) per room of the
window, in ms."""

from benchmark.metrics.vote_events import vote_event_mean


def read(rec):
    v = vote_event_mean(rec, "crop_s")
    return None if v is None else 1e3 * v
