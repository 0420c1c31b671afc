"""The 90th percentile (nearest rank) of the seconds from handing a scan
over to its logits being on the host, over every scan completed in the
window."""

import math


def read(rec):
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    lat = sorted(r["latency_s"] for r in rec["requests"])
    return lat[math.ceil(0.9 * len(lat)) - 1]
