"""The voting cell on the CPU at a small size (every width as configured,
its own limits): a sound run reads ``correct`` and fills what a CPU run
can fill, the faults and the precision control read false, the frozen
crop is the program's, the weights are the model's, the cell is found by
name, and the new readers read made-up records."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import cell, check, run, traffic, vote, weights
from benchmark.frozen import blocks as frozen_blocks
from benchmark.frozen import synthetic
from benchmark.metrics import reader
from benchmark.reference import models as ref_models
from benchmark.reference import vote as ref_vote
from benchmark.reference.precision import round_fp8

from conftest import ROOT

CELL = "s3dis_ctx.vote_rooms_200k"
SMALL = ({"batch_size": 4, "num_points": 256},
         {"base_scenes": 2, "profile_rooms": 1})
# read from the card's trace or counters, which a CPU run lacks
DEVICE_ONLY = {"conv_roofline.serve", "vote_idle_ms.serve"}
VOTE_READERS = ["vote_crop_ms.serve", "vote_scatter_ms.serve",
                "vote_idle_ms.serve", "vote_chunks.serve"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(4)


def _run(trace=False, seed=2 ** 31 + 41):
    return run.execute(CELL, seed, 0.0, trace, "cpu",
                       t_start=time.perf_counter(), log=lambda s: None,
                       config_update=SMALL[0], traffic_update=SMALL[1])


def _parts():
    bench = cell.load_benchmark()
    c, centry = cell.find(bench, CELL)
    cfg = dict(cell.load_json(ROOT, centry["file"]), **SMALL[0])
    return bench, cfg, dict(traffic.load(c["traffic"]), **SMALL[1])


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(tiny_rooms, trace):
    bench, _, _ = _parts()
    out = _run(trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"logit_gap", "logit_rms"}
    assert all(0 <= c["value"] < 0.05 for c in out["checks"].values())
    want = {m["name"] for m in cell.metrics_for(bench, CELL, trace)}
    assert set(out["metrics"]) == want - DEVICE_ONLY
    if trace:
        assert out["metrics"]["vote_chunks.serve"]["value"] > 0
        assert out["metrics"]["conv_launches.serve"]["value"] == 0


@pytest.mark.parametrize("fault", [vote.vote_moved, vote.chunk_left_out])
def test_faults(tiny_rooms, fault):
    with fault():
        out = _run()
    assert not out["correct"], out["checks"]


def test_precision_control(tiny_rooms):
    _, cfg, mix = _parts()
    seed = 2 ** 31 + 6
    w = weights.make(cfg, 6, vote.head_in(cfg), traffic.sub_seed(seed, 1),
                     "cpu")
    scenes = traffic.base_scenes(cfg, mix, seed)
    xyz, rgb = vote.room_request(cfg, mix, scenes, seed, 0)
    args = dict(num_classes=13, num_points=256, block_size=1.0,
                stride=mix["stride"], batch_size=4)
    with ref_models.float32_exact():
        ref = ref_vote.room_votes(w, cfg["radii"], xyz, rgb, **args)
        low = ref_vote.room_votes(w, cfg["radii"], xyz, rgb, rnd=round_fp8,
                                  **args)
    assert not check.correct(check.judge(check.logit_gaps(low, ref),
                                         cell.load_limits(CELL)))


def test_frozen_crop_is_the_programs():
    from pointwise_torch.data import s3dis

    xyz, rgb, lab = synthetic.segmentation_scene(
        3, num_objects=2, points_per_obj=200, room=1.5)
    for cover_all in (True, False):
        for seed in (0, 7):
            args = dict(num_points=128, block_size=1.0, stride=0.25,
                        cover_all=cover_all)
            a = s3dis.room_blocks(xyz, rgb, lab,
                                  rng=np.random.RandomState(seed), **args)
            b = frozen_blocks.room_blocks(
                xyz, rgb, lab, rng=np.random.RandomState(seed), **args)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_weights_are_the_models():
    from pointwise_torch.train import cli

    _, cfg, _ = _parts()
    model, _ = cli.build_segmenter(cell.port_config(cfg), torch.device("cpu"))
    w = weights.make(cfg, cfg["in_features"], vote.head_in(cfg), 5, "cpu")
    assert model.use_global_context
    assert vote.head_in(cfg) == model.head[0].in_features == 744
    assert {k: v.shape for k, v in w.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(w, strict=True)


def test_found_by_name():
    from pointwise_torch.train.configs import _REGISTRY

    bench, cfg, mix = _parts()
    c, centry = cell.find(bench, CELL)
    assert (c["chips"], centry["name"], centry["reduced"]) == (
        1, "s3dis_ctx", [])
    assert len(centry["source"]) <= 200
    assert set(cell.load_limits(CELL)) == {"logit_gap", "logit_rms"}
    assert mix["kind"] == "vote" and mix["stride"] == 0.25
    reg = _REGISTRY["s3dis"]
    full = cell.load_json(ROOT, centry["file"])
    port = cell.port_config(full)
    for k in ("num_points", "batch_size", "num_classes", "in_features",
              "channels", "radii", "head_dims", "dropout", "norm",
              "global_context", "block_size", "block_stride", "optimizer"):
        assert getattr(port, k) == getattr(reg, k), k
    assert mix["stride"] == reg.block_stride / 2
    for m in bench["per_layer"]:
        if m["name"] in VOTE_READERS:
            assert m["workloads"] == [CELL] and callable(reader(m["name"]))


def _rec(events, gaps):
    return {"kind": "serve", "window_s": 50.0, "setup_s": 9.0,
            "requests": [{"index": i, "latency_s": 4.0, "points": 196608,
                          "events": e} for i, e in enumerate(events)],
            "trace": {"busy_s": 1.0, "window_s": 8.0, "ops": {},
                      "gaps": gaps, "n": 2}}


def test_readers():
    ev = [{"crop_s": 1.0 + k, "forward_s": 1.5, "scatter_s": 0.5 * k,
           "chunks": 1300 + 2 * k, "pad_chunks": 12} for k in (1, 2)]
    rec = _rec(ev, {"vote.crop": 2.0, "vote.scatter": 1.0,
                    "aten::copy_": 0.5})
    assert reader("vote_crop_ms.serve")(rec) == pytest.approx(2500.0)
    assert reader("vote_scatter_ms.serve")(rec) == pytest.approx(750.0)
    assert reader("vote_chunks.serve")(rec) == pytest.approx(1303.0)
    assert reader("vote_idle_ms.serve")(rec) == pytest.approx(1500.0)
    # an engine's record, or a program without the voting path's events
    engine = _rec([{"plan_s": 0.1, "dispatch_s": 0.2}] * 2,
                  {"engine.dispatch": 0.3})
    for name in VOTE_READERS:
        assert reader(name)(engine) is None, name
    train = {"kind": "train", "steps": 3, "trace": engine["trace"]}
    for name in VOTE_READERS:
        assert reader(name)(train) is None, name


@pytest.mark.cuda
def test_cell_on_the_card():
    """The cell on the card with a window of two rooms (run there:
    ``python -m pytest -m cuda benchmark/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run.execute(CELL, 2 ** 31 + 79, 0.0, True, torch.device("cuda"))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    for name in VOTE_READERS + ["conv_roofline.serve", "mfu.serve"]:
        assert out["metrics"][name]["value"] >= 0, name
