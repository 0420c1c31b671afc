"""What the readers of the voting path's events share: the program's
``s3dis.predict_scene_voting`` fills each room's ``events`` with its spans'
seconds (``crop_s``, ``forward_s``, ``scatter_s``) and its chunk counts; a
record whose rooms lack them (a serving record, or a program without
them) leaves these metrics out."""

from __future__ import annotations


def vote_event_mean(rec, key: str):
    """The voting path's event ``key`` per room of the window, or None."""
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    ev = [r["events"] for r in rec["requests"]]
    if not all(key in e for e in ev):
        return None
    return sum(e[key] for e in ev) / len(ev)
