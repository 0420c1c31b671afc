"""The voting path's adding of each chunk's logits into the room's votes
(its ``vote.scatter`` span, the ``scatter_s`` event) per room of the
window, in ms."""

from benchmark.metrics.vote_events import vote_event_mean


def read(rec):
    v = vote_event_mean(rec, "scatter_s")
    return None if v is None else 1e3 * v
