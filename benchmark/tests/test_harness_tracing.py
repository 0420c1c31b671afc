"""The readers of the program's spans and host-sync counter: nothing from a
program without them (a record shaped as the first benchmark's), the
expected values from made-up records, and the counts in a CPU run."""

from __future__ import annotations

import pytest

from benchmark.metrics import reader

from conftest import run_small

SERVE = ["engine_fetch_ms.serve", "engine_wait_ms.serve",
         "engine_plan_ms.serve", "engine_idle_ms.serve", "host_syncs.serve"]
TRAIN = ["trainer_idle_ms.train", "host_syncs.train"]

# an engine's events before its phases were spans
OLD_EVENTS = {"presort_s": 0.02, "build_s": 0.1, "pack_s": 0.05,
              "wait_packer_s": 0.001, "dispatch_s": 0.17,
              "flush_fetch_s": 0.05, "flush_scatter_s": 0.004,
              "total_s": 0.42, "n_jobs": 40.0, "resident_bytes": 7e6}


def _serve(events, gaps):
    return {"kind": "serve", "window_s": 50.0, "setup_s": 9.0,
            "requests": [{"index": i, "latency_s": 0.4, "points": 196608,
                          "events": e} for i, e in enumerate(events)],
            "trace": {"busy_s": 0.5, "window_s": 1.3, "ops": {},
                      "gaps": gaps, "n": 3}}


def _train(gaps, steps=100):
    return {"kind": "train", "window_s": 50.0, "setup_s": 9.0,
            "steps": steps, "points_per_step": 65536,
            "launches": {"fwd_csr": 4 * steps},
            "trace": {"busy_s": 0.2, "window_s": 0.3, "ops": {},
                      "gaps": gaps, "n": 4}}


def test_nothing_from_a_program_without_spans(monkeypatch):
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels

    rec = _serve([OLD_EVENTS] * 3,
                 {"harness.stream_apply_layered": 0.436,
                  "cudaLaunchKernel": 0.016})
    for name in SERVE:
        assert reader(name)(rec) is None, name
    monkeypatch.delattr(kernels, "HOST_SYNCS")
    rec = _train({"harness.trainer_step": 0.039, "aten::copy_": 0.03})
    for name in TRAIN:
        assert reader(name)(rec) is None, name


def test_serve_readers():
    new = [dict(OLD_EVENTS, plan_s=0.03 * k, grid_s=0.02, host_syncs=90 + k,
                flush_fetch_s=0.05 * k, wait_packer_s=0.002 * k)
           for k in (1, 2, 3)]
    rec = _serve(new, {"engine.dispatch": 0.15, "engine.plan": 0.09,
                       "engine.fetch": 0.06, "aten::nonzero": 0.2,
                       "harness.stream_apply_layered": 0.003})
    assert reader("engine_fetch_ms.serve")(rec) == pytest.approx(100.0)
    assert reader("engine_wait_ms.serve")(rec) == pytest.approx(4.0)
    assert reader("engine_plan_ms.serve")(rec) == pytest.approx(60.0)
    assert reader("host_syncs.serve")(rec) == pytest.approx(92.0)
    # 0.3 s under engine.* over three traced scans; aten and harness out
    assert reader("engine_idle_ms.serve")(rec) == pytest.approx(100.0)
    # the old metrics read the same intervals as before
    assert reader("engine_prep_ms.serve")(rec) == pytest.approx(120.0)
    assert reader("engine_dispatch_ms.serve")(rec) == pytest.approx(170.0)
    assert reader("engine_idle_ms.serve")(_train({"train.forward": 1.0})) \
        is None


def test_train_readers(monkeypatch):
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels

    rec = _train({"train.forward": 0.012, "train.backward": 0.02,
                  "train.optimizer": 0.004, "aten::copy_": 0.03,
                  "harness.trainer_step": 0.001})
    assert reader("trainer_idle_ms.train")(rec) == pytest.approx(9.0)
    syncs = dict.fromkeys(kernels.HOST_SYNCS, 0)
    syncs["tile_lists"] = 7 * (100 + 4)       # window and traced steps
    monkeypatch.setattr(kernels, "HOST_SYNCS", syncs)
    assert reader("host_syncs.train")(rec) == pytest.approx(7.0)
    assert reader("host_syncs.train")(_serve([OLD_EVENTS], {})) is None
    assert reader("trainer_idle_ms.train")(
        _serve([OLD_EVENTS], {"train.forward": 1.0})) is None


@pytest.mark.parametrize("workload,names", [
    ("s3dis_seg.serve_scans_200k",
     ["engine_fetch_ms.serve", "engine_wait_ms.serve",
      "engine_plan_ms.serve", "host_syncs.serve"]),
    ("s3dis_seg.train_blocks", ["host_syncs.train"]),
])
def test_read_in_a_cpu_run(tiny_rooms, workload, names):
    """The span and counter readers find their numbers in a traced run of
    the program (the idle readers need the card's device trace)."""
    out = run_small(workload, trace=True)
    for name in names:
        assert out["metrics"][name]["value"] >= 0, name
    if workload.endswith("train_blocks"):
        # 2 x 256-point blocks take the dense walk: no tile lists
        assert out["metrics"]["host_syncs.train"]["value"] == 0
    else:
        # the resident scene's two uploads, a chunk's 12 puts and its fetch
        assert out["metrics"]["host_syncs.serve"]["value"] >= 2 + 13
