"""Points of all scans completed in the window over the window's seconds
(from the first request's hand-over to the last one's logits on the
host)."""


def read(rec):
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    return sum(r["points"] for r in rec["requests"]) / rec["window_s"]
