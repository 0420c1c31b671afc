"""The part segmenter's cell on the CPU at a small size (every width as
configured, its own limits): a sound run reads ``correct`` and fills what
a CPU run can fill, faults and the precision control read false, the
weights are the model's, the frozen shapes keep their categories' parts,
and the new readers read made-up records."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import calibrate, cell, check, partseg, run, traffic
from benchmark.frozen.partseg import REAL_PART_RANGES, part_set
from benchmark.metrics import reader
from benchmark.reference.precision import round_fp8

from conftest import ROOT
from test_harness_faults import state_unchanged

CELL = "shapenetpart_seg.train"
# 2,048 points a step: the loss is a mean over the points, and bf16's
# rounding averages out over them; at 2 x 128 points a sound run reads a
# loss_gap of 7e-5 to 1.7e-4 against the cell's 1.2e-4
SMALL = ({"batch_size": 4, "num_points": 512},
         {"pool_batches": 3, "profile_steps": 1})
# read from the card's trace or memory counters, which a CPU run lacks
DEVICE_ONLY = {"conv_roofline.train", "peak_mem_gib.train",
               "trainer_idle_ms.train", "partseg_idle_ms.train",
               "head_gemm_ms.train"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(4)


def _run(trace=False, seed=2 ** 31 + 29):
    return run.execute(CELL, seed, 0.0, trace, "cpu",
                       t_start=time.perf_counter(), log=lambda s: None,
                       config_update=SMALL[0], traffic_update=SMALL[1])


def _parts():
    bench = cell.load_benchmark()
    c, centry = cell.find(bench, CELL)
    cfg = dict(cell.load_json(ROOT, centry["file"]), **SMALL[0])
    return bench, cfg, dict(traffic.load(c["traffic"]), **SMALL[1])


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(trace):
    bench, _, _ = _parts()
    out = _run(trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(cell.load_limits(CELL))
    assert all(0 <= c["value"] < 0.1 for c in out["checks"].values())
    want = {m["name"] for m in cell.metrics_for(bench, CELL, trace)}
    assert set(out["metrics"]) == want - DEVICE_ONLY
    if trace:
        # 2 x 128 points take the dense walk: no tile lists
        assert out["metrics"]["host_syncs.train"]["value"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, calibrate.half_batch])
def test_faults(fault):
    with fault():
        out = _run()
    assert not out["correct"], out["checks"]
    if fault is calibrate.half_batch:
        c = out["checks"]["loss_gap"]
        assert c["value"] > c["limit"]


def test_precision_control():
    _, cfg, mix = _parts()
    seed = 2 ** 31 + 6
    w = partseg.make_weights(cfg, traffic.sub_seed(seed, 1), "cpu")
    pool = partseg.batch_pool(cfg, mix, seed)
    dev = torch.device("cpu")
    ref = partseg.reference_steps(cfg, pool, seed, w, 3, dev)
    low = partseg.reference_steps(cfg, pool, seed, w, 3, dev, rnd=round_fp8)
    assert not check.correct(check.judge(check.training_gaps(low, ref),
                                         cell.load_limits(CELL)))


def test_weights_are_the_models():
    from types import SimpleNamespace

    from pointwise_torch.train import cli

    _, cfg, _ = _parts()
    model, _ = cli.build_partseg(
        cell.port_config(cfg),
        SimpleNamespace(num_parts=cfg["num_classes"],
                        num_categories=cfg["num_categories"]),
        torch.device("cpu"))
    w = partseg.make_weights(cfg, 5, "cpu")
    assert set(w) == set(model.state_dict())
    assert partseg.head_in(cfg) == model.head[0].in_features == 1056
    model.load_state_dict(w, strict=True)


def test_frozen_shapes():
    from pointwise_torch.data import shapenetpart

    assert REAL_PART_RANGES == shapenetpart.REAL_PART_RANGES
    pts, cats, part = part_set(12345, 48, 256)
    assert pts.shape == (48, 256, 3) and pts.dtype == np.float32
    assert float(np.linalg.norm(pts, axis=-1).max()) <= 1.0 + 1e-6
    for c, lab in zip(cats, part):
        assert set(np.unique(lab)) <= set(REAL_PART_RANGES[int(c)])
    assert len(set(cats.tolist())) > 8
    assert len(np.unique(part)) > 25
    _, cfg, mix = _parts()
    a = partseg.batch_pool(cfg, mix, 2 ** 31 + 3)
    b = partseg.batch_pool(cfg, mix, 2 ** 31 + 3)
    c = partseg.batch_pool(cfg, mix, 2 ** 31 + 4)
    assert len(a) == mix["pool_batches"]
    for x, y in zip(a, b):
        assert set(x) == {"points", "category", "label", "mask"}
        assert all(np.array_equal(x[k], y[k]) for k in x)
        assert x["category"].dtype == x["label"].dtype == np.int32
        assert x["mask"].dtype == np.float32 and float(x["mask"].min()) == 1
    assert not np.array_equal(a[0]["points"], c[0]["points"])


def _rec(ops, gaps):
    return {"kind": "train", "window_s": 50.0, "setup_s": 9.0, "steps": 100,
            "points_per_step": 65536, "launches": {"fwd_dense": 600},
            "trace": {"busy_s": 0.2, "window_s": 0.3, "ops": ops,
                      "gaps": gaps, "n": 4}}


def test_readers():
    rec = _rec({"sm80_xmma_gemm_f32f32_f32f32_f32_tn_n": 0.006,
                "void_cutlass::Kernel2_cutlass_80_simt_sgemm_256x128": 0.002,
                "void_pw::pw_product_kernel_pw::FwdProduct": 0.01},
               {"partseg.context": 0.001, "partseg.head": 0.003,
                "train.forward": 0.02})
    assert reader("head_gemm_ms.train")(rec) == pytest.approx(2.0)
    assert reader("partseg_idle_ms.train")(rec) == pytest.approx(1.0)
    # a program without the spans, a trace without GEMMs: nothing
    old = _rec({"void_pw::pw_product_kernel_pw::FwdProduct": 0.01},
               {"train.forward": 0.02})
    assert reader("head_gemm_ms.train")(old) is None
    assert reader("partseg_idle_ms.train")(old) is None
    untraced = dict(rec)
    del untraced["trace"]
    assert reader("head_gemm_ms.train")(untraced) is None


@pytest.mark.cuda
def test_cell_on_the_card():
    """The cell on the card with a window of one step (run there:
    ``python -m pytest -m cuda benchmark/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run.execute(CELL, 2 ** 31 + 77, 0.0, True, torch.device("cuda"))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    for name in ("partseg_idle_ms.train", "head_gemm_ms.train"):
        assert out["metrics"][name]["value"] >= 0, name
