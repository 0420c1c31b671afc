"""The result line's keys, names and units (a CPU run at a small size)."""

from __future__ import annotations

import json

import pytest

from benchmark import cell

from conftest import run_small


@pytest.mark.parametrize("workload", ["s3dis_seg.serve_scans_200k",
                                      "modelnet40_cls.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_rooms, workload, trace):
    out = json.loads(json.dumps(run_small(workload, trace=trace)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for k in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][k]) <= 10
    want = {m["name"]: m["unit"]
            for m in cell.metrics_for(cell.load_benchmark(), workload, trace)}
    assert set(out["metrics"]) <= set(want)
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == want[name]
    if not trace:      # the end-to-end metrics need no card to be read
        assert set(out["metrics"]) == set(want)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
