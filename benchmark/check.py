"""The comparisons that decide ``correct``: each compared number and its
limit (benchmark/limits/<cell>.json).  A number is correct when it is
finite and at most its limit."""

from __future__ import annotations

import math

import torch


def logit_gaps(port, ref) -> dict:
    """Served logits against the reference's, both (N, classes):
    ``logit_gap`` the widest gap over every point and class, and
    ``logit_rms`` the root mean square gap, both over the reference's
    largest magnitude / root mean square."""
    port = torch.as_tensor(port, dtype=torch.float32, device=ref.device)
    d = port - ref
    return dict(
        logit_gap=float(d.abs().max() / ref.abs().max()),
        logit_rms=float(torch.sqrt((d * d).mean() / (ref * ref).mean())))


def _leaf_gap(port: dict, ref: dict, keep=None):
    """(worst leaf's |norm(port) - norm(ref)| over max(norm(ref), the
    median leaf's norm(ref)), that leaf's name)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in names}
    pn = {k: float(torch.linalg.vector_norm(port[k].float())) for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    gap = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}
    worst = max(gap, key=gap.get)
    return gap[worst], worst


def training_gaps(port: dict, ref: dict, log=None) -> dict:
    """A training run's first steps against the reference's.  Each side:
    ``losses`` (the first steps' losses), ``grad`` {leaf: the first
    gradient as the optimizer took it} and ``change`` {leaf: parameters
    after the first steps minus before}.  ``loss_gap`` the worst step's
    relative loss gap; ``grad_gap`` and ``change_gap`` by the worst leaf
    (``_leaf_gap``); leaves whose reference gradient is under a thousandth
    of the median leaf's move by rounding alone and are left out of the
    change.  ``log`` is told the worst leaves' names."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(port["losses"], ref["losses"]))
    gn = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad"].items()}
    med = sorted(gn.values())[len(gn) // 2]
    moving = {k for k, v in gn.items() if v >= 1e-3 * med}
    grad_gap, grad_leaf = _leaf_gap(port["grad"], ref["grad"])
    change_gap, change_leaf = _leaf_gap(port["change"], ref["change"], moving)
    if log is not None:
        log(f"# worst leaves: gradient {grad_leaf}, change {change_leaf}")
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def judge(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every compared number; a reading
    without a limit is an error."""
    missing = sorted(set(readings) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}


def correct(checks: dict) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
