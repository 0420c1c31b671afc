"""Whole-room voting with the pooled segmenter against the benchmark's
plain reference, on the CPU.

``PointwiseSegmenter`` with its global pool on the port's plain CPU path,
convs in float32, labels a small procedural room through
``s3dis.predict_scene_voting`` and ``eval.block_predictor``;
``benchmark/reference/vote.py`` votes over the same chunks with the same
seeded weights (``benchmark.weights.make``).  The program's crop equals
the frozen one (``benchmark/frozen/blocks.room_blocks``) array for array,
with the native library and without it.  And the voting path's events
and spans, and ``eval_segmentation`` unchanged by the predictor's move out
of it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from benchmark import cell, traffic, weights
from benchmark.frozen import blocks as frozen_blocks
from benchmark.frozen import synthetic
from benchmark.reference import models as ref_models
from benchmark.reference import vote as ref_vote
from pointwise_torch import eval as port_eval
from pointwise_torch import native
from pointwise_torch.data import s3dis
from pointwise_torch.models import PointwiseSegmenter
from pointwise_torch.train import get_config

# Both sides compute in float32 with the same operations in other orders
# (the port's cell sums against the reference's masked products, np.add.at
# against index_add_): test_harness_reference.py's 2e-5 of the largest
# magnitude holds a logit, and a vote adds up to ~16 of them, each
# rounded alike, so the same share of the largest vote holds.
TOL = 2e-5
CFG = dict(channels=[8, 8], radii=[0.15, 0.3], head_dims=[16],
           num_classes=5, in_features=6)
VOTING = dict(num_classes=5, num_points=128, block_size=1.0, batch_size=4)
SPANS = ("vote.crop", "vote.forward", "vote.scatter", "seg.context")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=4, global_context=True):
    model = PointwiseSegmenter(
        num_classes=CFG["num_classes"], in_features=6,
        channels=CFG["channels"], radii=CFG["radii"],
        head_dims=CFG["head_dims"], dropout_rate=0.3, impl="reference",
        precision="float32", use_global_context=global_context,
        device="cpu")
    head_in = sum(CFG["channels"]) + (2 * CFG["channels"][-1]
                                      if global_context else 0)
    w = weights.make(CFG, 6, head_in, seed, "cpu")
    model.load_state_dict(w, strict=True)
    return model.eval(), w


def _room(seed=1):
    xyz, rgb, _ = synthetic.segmentation_scene(
        seed, num_objects=2, points_per_obj=150, room=1.5)
    return xyz.astype(np.float32), rgb


def test_weights_are_the_models_parameters():
    model, w = _model()
    assert set(w) == set(model.state_dict())
    assert w["head.0.weight"].shape == (16, 32)


@pytest.mark.parametrize("stride", [0.25, 0.5])
def test_votes_match_the_reference_in_float32(stride):
    model, w = _model()
    xyz, rgb = _room()
    res = s3dis.predict_scene_voting(
        port_eval.block_predictor(model, torch.device("cpu")), xyz, rgb,
        stride=stride, **VOTING)
    with ref_models.float32_exact():
        ref = ref_vote.room_votes(w, CFG["radii"], xyz, rgb, stride=stride,
                                  **VOTING)
    got = torch.from_numpy(res["votes"])
    assert res["covered"].all()
    assert float(ref.abs().max()) > 0
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
    np.testing.assert_array_equal(res["pred"], ref.argmax(1).numpy())


@pytest.mark.parametrize("stride", [0.25, 0.5])
def test_events_count_the_chunks(stride):
    model, _ = _model()
    xyz, rgb = _room(2)
    ev = {}
    s3dis.predict_scene_voting(
        port_eval.block_predictor(model, torch.device("cpu")), xyz, rgb,
        stride=stride, events=ev, **VOTING)
    blocks = frozen_blocks.room_blocks(
        xyz, rgb, np.zeros(len(xyz), np.int32), num_points=128,
        block_size=1.0, stride=stride, rng=np.random.RandomState(0),
        cover_all=True)
    assert set(ev) == {"crop_s", "forward_s", "scatter_s", "chunks",
                       "crop_native", "pad_chunks"}
    assert all(ev[k] > 0 for k in ("crop_s", "forward_s", "scatter_s"))
    assert ev["chunks"] == len(blocks["points"])
    assert native.available() and ev["crop_native"] == ev["chunks"]
    assert ev["pad_chunks"] == -ev["chunks"] % VOTING["batch_size"]
    assert (ev["chunks"] + ev["pad_chunks"]) % VOTING["batch_size"] == 0


def test_crop_native_is_zero_without_the_library(monkeypatch):
    model, _ = _model()
    xyz, rgb = _room(2)
    ev = {}
    monkeypatch.setattr(native, "_lib", False)
    s3dis.predict_scene_voting(
        port_eval.block_predictor(model, torch.device("cpu")), xyz, rgb,
        stride=0.25, events=ev, **VOTING)
    assert ev["chunks"] > 0 and ev["crop_native"] == 0


def _library(monkeypatch, on):
    """The native crop when ``on`` (asserting that it loaded), else the
    NumPy path."""
    if on:
        assert native.available()
    else:
        monkeypatch.setattr(native, "_lib", False)


def _same_crop(xyz, rgb, lab, seed, frozen=None, **kw):
    """The program's crop, asserted equal to the frozen one (``frozen``
    when given) array for array."""
    a = s3dis.room_blocks(xyz, rgb, lab, rng=np.random.RandomState(seed),
                          **kw)
    b = frozen or frozen_blocks.room_blocks(
        xyz, rgb, lab, rng=np.random.RandomState(seed), **kw)
    assert set(a) == set(b) == {"points", "features", "label", "mask",
                                "index"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    return a


@pytest.fixture(scope="module")
def full_room():
    """One request of the voting cell: a 196,608-point room, turned and
    moved as ``traffic.scan_request`` serves it, the crop's arguments at
    the cell's 1 m windows and 0.25 m stride, and its frozen crop."""
    bench = cell.load_benchmark()
    c, centry = cell.find(bench, "s3dis_ctx.vote_rooms_200k")
    cfg = cell.load_json(cell.ROOT, centry["file"])
    mix = traffic.load(c["traffic"])
    xyz, _ = traffic.scan_request(
        cfg, mix, traffic.base_scenes(cfg, mix, 2**31 + 5), 2**31 + 5, 0)
    rgb = np.random.RandomState(3).uniform(0, 1, xyz.shape).astype(
        np.float32)
    lab = np.random.RandomState(4).randint(0, 13, len(xyz)).astype(np.int32)
    kw = dict(num_points=cfg["num_points"], block_size=cfg["block_size"],
              stride=mix["stride"], cover_all=True)
    frozen = frozen_blocks.room_blocks(xyz, rgb, lab,
                                       rng=np.random.RandomState(0), **kw)
    return xyz, rgb, lab, kw, frozen


@pytest.mark.parametrize("on", [True, False], ids=["native", "numpy"])
def test_crop_of_a_full_room_is_the_frozen_one(monkeypatch, full_room, on):
    xyz, rgb, lab, kw, frozen = full_room
    assert len(xyz) == 196_608 and kw["stride"] == 0.25
    _library(monkeypatch, on)
    blocks = _same_crop(xyz, rgb, lab, 0, frozen, **kw)
    assert len(blocks["points"]) > 1000


@pytest.mark.parametrize("on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("cover_all", [True, False])
@pytest.mark.parametrize("feature_mode", ["rgb_norm", "rgb"])
@pytest.mark.parametrize("seed", [0, 7])
def test_crop_is_the_frozen_one(monkeypatch, on, cover_all, feature_mode,
                                seed):
    xyz, rgb, lab = synthetic.segmentation_scene(
        5, num_objects=3, points_per_obj=300, room=2.5)
    _library(monkeypatch, on)
    blocks = _same_crop(xyz, rgb, lab, seed, num_points=128, block_size=1.0,
                        stride=0.25, cover_all=cover_all,
                        feature_mode=feature_mode)
    assert blocks["features"].shape[2] == (6 if feature_mode == "rgb_norm"
                                           else 3)


@pytest.mark.parametrize("on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("cover_all", [True, False])
def test_crop_on_window_edges(monkeypatch, on, cover_all):
    """Points on the windows' edges (the room's minimum plus multiples of
    the stride, exact in float32) and on their float32 neighbours, a dense
    corner and sparse windows under ``min_points``."""
    rng = np.random.RandomState(11)
    lo = np.float32([-1.25, 0.5, 0.0])
    edges = lo[:2] + np.float32(0.25) * np.arange(13, dtype=np.float32)[
        :, None]
    grid = np.stack([edges[:, 0], np.nextafter(edges[:, 0], np.float32(-9)),
                     np.nextafter(edges[:, 0], np.float32(9))], 1).ravel()
    gy = np.stack([edges[:, 1], np.nextafter(edges[:, 1], np.float32(-9)),
                   np.nextafter(edges[:, 1], np.float32(9))], 1).ravel()
    n = 3000
    xyz = np.empty((n, 3), np.float32)
    xyz[:, 0] = rng.choice(grid[grid >= lo[0]], n)
    xyz[:, 1] = rng.choice(gy[gy >= lo[1]], n)
    xyz[:, 2] = rng.uniform(0, 1, n)
    xyz[: n // 2, :2] = lo[:2] + rng.uniform(0, 0.6, (n // 2, 2))
    xyz[0] = lo                              # the room's minimum
    sparse = np.all(xyz[:, :2] >= lo[:2] + 2.0, axis=1)
    xyz = xyz[~sparse | (rng.uniform(size=n) < 0.05)]
    rgb = rng.uniform(0, 1, xyz.shape).astype(np.float32)
    lab = rng.randint(0, 5, len(xyz)).astype(np.int32)
    assert xyz.min(0)[0] == lo[0] and xyz.min(0)[1] == lo[1]
    on_edge = np.isin(xyz[:, 0], edges[:, 0]) | np.isin(xyz[:, 1],
                                                        edges[:, 1])
    assert on_edge.sum() > 100
    _library(monkeypatch, on)
    kw = dict(num_points=64, block_size=1.0, stride=0.25,
              cover_all=cover_all)
    blocks = _same_crop(xyz, rgb, lab, 3, **kw)
    # some windows hold fewer than min_points (32) points and emit nothing
    xs = np.arange(lo[0], xyz[:, 0].max() + 1e-6, 0.25)
    ys = np.arange(lo[1], xyz[:, 1].max() + 1e-6, 0.25)
    held = [np.sum((xyz[:, 0] >= x0) & (xyz[:, 0] < x0 + 1.0)
                   & (xyz[:, 1] >= y0) & (xyz[:, 1] < y0 + 1.0))
            for x0 in xs for y0 in ys]
    assert min(held) < 32 <= max(held)
    assert len(blocks["points"]) >= sum(h >= 32 for h in held)


def _ranges(fn):
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()]
    return out, {s: names.count(s) for s in SPANS}


@pytest.mark.parametrize("global_context", [True, False])
def test_spans_under_a_profiler(global_context):
    model, _ = _model(global_context=global_context)
    xyz, rgb = _room()
    ev = {}

    def vote():
        return s3dis.predict_scene_voting(
            port_eval.block_predictor(model, torch.device("cpu")), xyz, rgb,
            stride=0.5, events=ev, **VOTING)

    plain = vote()["votes"]
    traced, counts = _ranges(vote)
    batches = (ev["chunks"] + ev["pad_chunks"]) // VOTING["batch_size"]
    assert counts == {"vote.crop": 1, "vote.forward": batches,
                      "vote.scatter": batches,
                      "seg.context": batches if global_context else 0}
    np.testing.assert_array_equal(plain, traced["votes"])


def _closure_predictor(model, device):
    """eval_segmentation's predictor as it was written inside it."""

    def predict(points, features, mask):
        with torch.inference_mode():
            return model(port_eval._tensor(points, device),
                         port_eval._tensor(features, device),
                         port_eval._tensor(mask, device)).cpu().numpy()

    return predict


class _Args:
    def __init__(self, data_dir):
        self.data_dir, self.checkpoint_dir, self.params = data_dir, None, None
        self.stride, self.streaming = None, False


def test_eval_segmentation_unchanged(tmp_path, monkeypatch, capsys):
    """``s3dis_synthetic`` (the global pool on) at narrow widths on two
    small rooms: the same line and the same predictions through
    ``block_predictor`` as through the closure it replaced."""
    rng = np.random.RandomState(5)
    for i in range(2):
        xyz = rng.uniform(0.0, 1.5, (200, 3)).astype(np.float32)
        rgb = rng.uniform(0.0, 1.0, (200, 3)).astype(np.float32)
        lab = rng.randint(0, 5, (200, 1)).astype(np.float32)
        np.save(tmp_path / f"room{i}.npy", np.concatenate([xyz, rgb, lab], 1))
    cfg = dataclasses.replace(
        get_config("s3dis_synthetic"), channels=(8, 8), radii=(0.25, 0.5),
        head_dims=(16,), num_points=128, impl="reference")
    assert cfg.global_context
    args = _Args(str(tmp_path))
    calls, preds = [], []
    real_predictor = port_eval.block_predictor
    real_vote = s3dis.predict_scene_voting

    def spy(model, device):
        calls.append(model.use_global_context)
        return real_predictor(model, device)

    def keep(*a, **k):
        out = real_vote(*a, **k)
        preds.append(out["pred"])
        return out

    monkeypatch.setattr(port_eval.s3dis, "predict_scene_voting", keep)

    def line(predictor):
        monkeypatch.setattr(port_eval, "block_predictor", predictor)
        port_eval.eval_segmentation(cfg, args, torch.device("cpu"))
        out = capsys.readouterr().out
        return [json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")]

    new = line(spy)
    old = line(_closure_predictor)
    assert calls == [True]
    assert new == old and new[0]["metric"] == "segmentation"
    assert len(preds) == 4
    for a, b in zip(preds[:2], preds[2:]):
        np.testing.assert_array_equal(a, b)
