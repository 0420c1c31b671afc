"""The streaming engine's dispatch loop per scan of the window: staging
and launching each chunk of tiles (the engine's own ``dispatch_s``
event), in ms."""


def read(rec):
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    ev = [r["events"] for r in rec["requests"]]
    return 1e3 * sum(e["dispatch_s"] for e in ev) / len(ev)
