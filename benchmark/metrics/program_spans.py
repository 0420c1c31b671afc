"""What the readers of the program's own spans and counters share.  The
streaming engine times each phase of its calling thread as a span of the
program (``pointwise_torch.utils.runtime.span``) and fills its per-scan
``events`` from them; an engine without those spans (its events hold no
``plan_s``, which came with them) leaves these metrics out, as do traces
that name no span of the program."""

from __future__ import annotations


def engine_event_mean(rec, key: str):
    """The engine's event ``key`` per scan of the window, or None."""
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    ev = [r["events"] for r in rec["requests"]]
    if not all("plan_s" in e and key in e for e in ev):
        return None
    return sum(e[key] for e in ev) / len(ev)


def idle_under_ms(rec, kind: str, prefix: str):
    """The device's idle time that the trace puts down to the program's
    spans named ``prefix...`` (the innermost host range open at each idle
    gap's middle, benchmark/devtrace.py) per traced scan or step, in ms;
    None where no gap fell under such a span."""
    if rec["kind"] != kind or "trace" not in rec:
        return None
    t = rec["trace"]
    secs = [s for name, s in t["gaps"].items() if name.startswith(prefix)]
    if not secs or not t["n"]:
        return None
    return 1e3 * sum(secs) / t["n"]
