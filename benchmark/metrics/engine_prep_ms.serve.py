"""The streaming engine's host preparation per scan of the window: its
global morton presort and its tile schedule build (the engine's own
``presort_s`` and ``build_s`` events), in ms."""


def read(rec):
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    ev = [r["events"] for r in rec["requests"]]
    return 1e3 * sum(e["presort_s"] + e["build_s"] for e in ev) / len(ev)
