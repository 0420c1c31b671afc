"""The end-to-end readers over every request and step of a window, a
stall included."""

from __future__ import annotations

import pytest

from benchmark.metrics import reader


def _serve(latencies, window_s, points=1000):
    return {"kind": "serve", "window_s": window_s, "setup_s": 1.0,
            "requests": [{"index": i, "latency_s": t, "points": points,
                          "events": {}} for i, t in enumerate(latencies)]}


def test_rate_counts_the_whole_window_with_a_stall():
    lat = [0.1] * 19 + [5.0]              # one request stalls for 5 s
    rec = _serve(lat, window_s=sum(lat) + 0.2)
    assert reader("serve_pts_per_s")(rec) == pytest.approx(20 * 1000 / 7.1)


def test_p90_is_over_all_requests():
    # 30 requests: ranks 28..30 are the three slowest; the 27th of 30 is
    # the 90th percentile by nearest rank
    lat = [0.1 * (i + 1) for i in range(30)]
    assert reader("serve_p90_s")(_serve(lat, 50.0)) == pytest.approx(2.7)
    lat = [0.2] * 27 + [9.0] * 3          # a tail beyond p90 leaves it
    assert reader("serve_p90_s")(_serve(lat, 50.0)) == pytest.approx(0.2)
    lat = [0.2] * 26 + [9.0] * 4          # a tail of 4 in 30 reaches it
    assert reader("serve_p90_s")(_serve(lat, 50.0)) == pytest.approx(9.0)


def test_training_rate_and_serve_metrics_stay_out():
    rec = {"kind": "train", "steps": 100, "points_per_step": 65536,
           "window_s": 8.0, "setup_s": 2.0}
    assert reader("train_pts_per_s")(rec) == pytest.approx(819200.0)
    assert reader("serve_pts_per_s")(rec) is None
    assert reader("train_pts_per_s")(_serve([0.1], 1.0)) is None


def test_conv_roofline_needs_a_matching_kernel():
    rec = {"kind": "serve", "trace": {"ops": {"void at::native::gemm": 0.5}},
           "work": {"traced_conv_least_s": 0.001}}
    assert reader("conv_roofline.serve")(rec) is None
    rec["trace"]["ops"]["void pw::pw_walk_kernel<pw::FwdMeans, bf16, 16>"] = 0.2
    assert reader("conv_roofline.serve")(rec) == pytest.approx(0.5)
