"""ShapeNetPart and SceneNN in the port, held against the JAX package.

The part segmenter's logits against the JAX ``ShapeNetPartSegmenter`` on
the same weights (a flax init or numpy-seeded JAX-layout arrays through
convert.py; f32, 2e-5); the part-segmentation data (synthetic sets, the
.h5 loader, batches, instance mIoU) equal to the JAX module's; the train
CLI on ``shapenetpart_tiny`` and ``scenenn_tiny``; and the SceneNN loader,
which raises on a data directory without scenes where the JAX loader
falls back to procedural ones.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_torch.convert import (flatten, load_shapenetpart,
                                     random_shapenetpart_params,
                                     shapenetpart_state_dict)
from pointwise_torch.data import scenenn as t_scenenn
from pointwise_torch.data import shapenetpart as t_spp
from pointwise_torch.models import ShapeNetPartSegmenter
from pointwise_torch.train.cli import main as train
from pointwise_tpu.data import scenenn as j_scenenn
from pointwise_tpu.data import shapenetpart as j_spp
from pointwise_tpu.data import synthetic as j_synthetic
from pointwise_tpu.models import ShapeNetPartSegmenter as JaxPartSegmenter
from test_torch_train_cli import assert_resumed_run_equal

TINY = dict(num_parts=48, num_categories=16, channels=(8, 8),
            radii=(0.3, 0.5), head_dims=(16,), dropout_rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _clouds(seed=0, b=3, n=160):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    cat = rng.randint(0, 16, b).astype(np.int32)
    mask = (rng.rand(b, n) > 0.15).astype(np.float32)
    return pts, cat, mask


def _models(norm="layer"):
    jm = JaxPartSegmenter(**TINY, norm=norm, impl="reference",
                          precision="float32")
    tm = ShapeNetPartSegmenter(**TINY, norm=norm, precision="float32").eval()
    return jm, tm


def _logits(tm, pts, cat, mask):
    with torch.no_grad():
        return tm(torch.from_numpy(pts), torch.from_numpy(cat),
                  mask=torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_flax_init_carries_over(norm):
    jm, tm = _models(norm)
    pts, cat, mask = _clouds()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), pts, cat,
                                       mask=mask))
    load_shapenetpart(tm, variables)
    # flax names the category embedding Dense_0; the head follows it
    sd = shapenetpart_state_dict(variables)
    flat = flatten(variables)
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  flat["params/Dense_0/kernel"].T)
    np.testing.assert_array_equal(sd["head.0.weight"].numpy(),
                                  flat["params/Dense_1/kernel"].T)
    assert sd["head.0.weight"].shape == (16, 16 + 16 + 64)
    assert sd["out.weight"].shape == (48, 16)
    want = np.asarray(jm.apply(variables, pts, cat, mask=mask))
    got = _logits(tm, pts, cat, mask)
    assert got.shape == (3, 160, 48)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.all(got[mask == 0] == 0)


def test_numpy_params_drive_both_models():
    jm, tm = _models()
    flat = random_shapenetpart_params(48, 16, channels=TINY["channels"],
                                      head_dims=TINY["head_dims"], seed=5)
    load_shapenetpart(tm, flat)
    pts, cat, mask = _clouds(1)
    want = np.asarray(jm.apply(_unflatten(flat), pts, cat, mask=mask))
    np.testing.assert_allclose(_logits(tm, pts, cat, mask), want,
                               rtol=2e-5, atol=2e-5)
    # strict: a tree without the embedding does not load
    flat.pop("params/Dense_0/kernel")
    with pytest.raises(RuntimeError, match="Missing"):
        load_shapenetpart(tm, flat)


@pytest.mark.parametrize("variant", ["default", "hard"])
def test_synthetic_sets_equal_jax(variant):
    for split in ("train", "test"):
        a = t_spp.load_shapenetpart(None, split, 96, synthetic_size=10,
                                    seed=3, variant=variant)
        b = j_spp.load_shapenetpart(None, split, 96, synthetic_size=10,
                                    seed=3, variant=variant)
        for f in ("points", "category", "part"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.num_parts == b.num_parts == 48
        assert a.parts_per_category == b.parts_per_category
    for x, y in zip(t_spp.batches(a, 4, seed=2, drop_remainder=False),
                    j_spp.batches(b, 4, seed=2, drop_remainder=False)):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_category_miou_equals_jax():
    rng = np.random.RandomState(4)
    cat = rng.randint(0, 16, 12)
    label = np.stack([c * 3 + rng.randint(0, 3, 50) for c in cat])
    pred = np.where(rng.rand(12, 50) < 0.7, label, rng.randint(0, 48,
                                                               (12, 50)))
    data = t_spp.synthetic_set(0, 2, 16)
    for ppc in (data.parts_per_category, None):
        assert t_spp.category_miou(pred, label, cat, ppc) == \
            j_spp.category_miou(pred, label, cat, ppc)


def test_h5_shards_load_as_in_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(6)
    for i in range(2):
        with h5py.File(tmp_path / f"ply_data_train{i}.h5", "w") as h:
            h["data"] = rng.uniform(-1, 1, (3, 80, 3)).astype(np.float32)
            h["label"] = rng.randint(0, 16, (3, 1)).astype(np.uint8)
            h["pid"] = rng.randint(0, 50, (3, 80)).astype(np.uint8)
    a = t_spp.load_shapenetpart(os.fspath(tmp_path), "train", 64)
    b = j_spp.load_shapenetpart(os.fspath(tmp_path), "train", 64)
    assert a.points.shape == (6, 64, 3)
    for f in ("points", "category", "part"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.parts_per_category == b.parts_per_category \
        == t_spp.REAL_PART_RANGES
    assert a.num_parts == 50


def test_h5_dir_needs_h5py(tmp_path, monkeypatch):
    (tmp_path / "ply_data_train0.h5").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)      # import fails
    with pytest.raises(RuntimeError, match="h5py"):
        t_spp.load_shapenetpart(os.fspath(tmp_path), "train")


def test_train_shapenetpart_tiny(capsys, tmp_path):
    trainer = train(["--config", "shapenetpart_tiny", "--steps", "3",
                     "--device", "cpu"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(math.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in recs)
    # the head is as wide as the data's 48 synthetic parts, not the
    # config's 50
    assert trainer.model.out.weight.shape[0] == 48
    assert_resumed_run_equal(["--config", "shapenetpart_tiny", "--device",
                              "cpu"], tmp_path)


def test_scenenn_loader_and_training(tmp_path, capsys):
    # no data directory: the procedural NYU-40 scenes, as in JAX
    for (xa, ra, la), (xb, rb, lb) in zip(
            t_scenenn.load_scenes(None, synthetic_scenes=2, seed=1),
            j_scenenn.load_scenes(None, synthetic_scenes=2, seed=1)):
        for a, b in ((xa, xb), (ra, rb), (la, lb)):
            np.testing.assert_array_equal(a, b)
    # a directory without scenes raises (the JAX loader falls back)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no scene"):
        t_scenenn.load_scenes(os.fspath(empty))
    scenes = tmp_path / "scenes"
    scenes.mkdir()
    for i in range(2):
        xyz, rgb, lab = j_synthetic.scenenn_scene(
            seed=i, num_objects=6, points_per_obj=80, room=2.0)
        np.save(scenes / f"scene{i}.npy", np.concatenate(
            [xyz, rgb, lab[:, None].astype(np.float32)], 1))
    got = t_scenenn.load_scenes(os.fspath(scenes))
    want = j_scenenn.load_scenes(os.fspath(scenes))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    trainer = train(["--config", "scenenn_tiny", "--steps", "3",
                     "--data-dir", os.fspath(scenes), "--device", "cpu"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert all(math.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert trainer.model.out.weight.shape[0] == 40
    with pytest.raises(FileNotFoundError, match="no scene"):
        train(["--config", "scenenn_tiny", "--steps", "1", "--data-dir",
               os.fspath(empty), "--device", "cpu"])


def test_partseg_refuses_spatial_shards():
    # --sp shards semantic segmentation only; ShapeNetPart trains under --dp
    with pytest.raises(ValueError, match="--dp"):
        train(["--config", "shapenetpart_tiny", "--sp", "2", "--steps", "1",
               "--device", "cpu"])
