"""``correct`` comes out false for the precision control and for every
fault a cell can have, planted under a run that skips only the look for a
card (a CPU run at a small size, every width as configured, the cells'
own limits)."""

from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark import calibrate, cell, check, traffic, weights
from benchmark import train as train_loop
from benchmark.reference import models as ref_models
from benchmark.reference.precision import round_fp8

from conftest import ROOT, SMALL, run_small

SERVE = ["s3dis_seg.serve_scans_200k", "s3dis_seg.serve_rooms_1m"]
TRAIN = ["s3dis_seg.train_blocks", "modelnet40_cls.train"]


@contextlib.contextmanager
def state_unchanged():
    """The optimizer's update skipped: every step leaves the parameters
    and the optimizer's state as they were."""
    real = torch.optim.AdamW.step
    torch.optim.AdamW.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.AdamW.step = real


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_sound_run_reads_every_number(tiny_rooms, workload):
    """A sound run at the small size (whose readings the cells' limits
    were not set from) gives every compared number, finite and below the
    faults' readings, last in its line."""
    out = run_small(workload)
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell.load_limits(workload))
    assert all(0 <= c["value"] < 0.1 for c in out["checks"].values())


@pytest.mark.parametrize("workload", SERVE)
def test_answer_altered(tiny_rooms, workload):
    with calibrate.answer_altered():
        out = run_small(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [state_unchanged, calibrate.half_batch])
def test_training_faults(tiny_rooms, workload, fault):
    with fault():
        out = run_small(workload)
    assert not out["correct"], out["checks"]


def _parts(workload):
    bench = cell.load_benchmark()
    c, centry = cell.find(bench, workload)
    cfg_update, mix_update = SMALL[workload]
    cfg = dict(cell.load_json(ROOT, centry["file"]), **(cfg_update or {}))
    mix = dict(traffic.load(c["traffic"]), **mix_update)
    return cfg, mix, cell.load_limits(workload)


@pytest.mark.parametrize("workload", SERVE)
def test_precision_control_serving(tiny_rooms, workload):
    """The reference in fp8 in the program's place."""
    cfg, mix, limits = _parts(workload)
    seed = 2 ** 31 + 5
    w = weights.make(cfg, cfg["in_features"], sum(cfg["channels"]),
                     traffic.sub_seed(seed, 1), "cpu")
    scenes = traffic.base_scenes(cfg, mix, seed)
    xyz, feats = traffic.scan_request(cfg, mix, scenes, seed, 0)
    x, f = torch.from_numpy(xyz), torch.from_numpy(feats)
    with ref_models.float32_exact():
        ref = ref_models.segmenter_scene_logits(w, cfg["radii"], x, f)
        low = ref_models.segmenter_scene_logits(w, cfg["radii"], x, f,
                                                rnd=round_fp8)
    assert not check.correct(check.judge(check.logit_gaps(low, ref), limits))


@pytest.mark.parametrize("workload", TRAIN)
def test_precision_control_training(tiny_rooms, workload):
    cfg, mix, limits = _parts(workload)
    seed = 2 ** 31 + 6
    cin, head_in = train_loop._net_inputs(cfg)
    w = weights.make(cfg, cin, head_in, traffic.sub_seed(seed, 1), "cpu")
    pool = traffic.batch_pool(cfg, mix, seed)
    dev = torch.device("cpu")
    ref = train_loop.reference_steps(cfg, pool, seed, w, 3, dev)
    low = train_loop.reference_steps(cfg, pool, seed, w, 3, dev,
                                       rnd=round_fp8)
    assert not check.correct(check.judge(check.training_gaps(low, ref),
                                         limits))
