"""The PyTorch port's copies of the host modules, and its import isolation.

The port keeps its own copies of the numpy-only modules of the JAX package
(configs, spatial, synthetic, s3dis, the native grid hash) so that it
imports nothing of JAX; for the same seeds they must return the same arrays.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import pointwise_torch
from pointwise_torch import native as t_native
from pointwise_torch.data import s3dis as t_s3dis
from pointwise_torch.data import synthetic as t_syn
from pointwise_torch.train import configs as t_cfg
from pointwise_torch.utils import spatial as t_spatial
from pointwise_tpu import native as j_native
from pointwise_tpu.data import s3dis as j_s3dis
from pointwise_tpu.data import synthetic as j_syn
from pointwise_tpu.train import configs as j_cfg
from pointwise_tpu.utils import spatial as j_spatial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_configs_identical():
    assert sorted(t_cfg._REGISTRY) == sorted(j_cfg._REGISTRY)
    for name in j_cfg._REGISTRY:
        assert (dataclasses.asdict(t_cfg.get_config(name))
                == dataclasses.asdict(j_cfg.get_config(name))), name
    with pytest.raises(KeyError):
        t_cfg.get_config("nope")


def test_spatial_identical():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2, 3, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_spatial.morton_code(pts),
                                  j_spatial.morton_code(pts))
    extra = rng.rand(500)
    _eq(t_spatial.morton_sort(pts, extra), j_spatial.morton_sort(pts, extra))
    with pytest.raises(ValueError):
        t_spatial.check_coordinates(pts * 1e6)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_identical(seed):
    _eq(t_syn.segmentation_scene(seed, num_objects=4, points_per_obj=64),
        j_syn.segmentation_scene(seed, num_objects=4, points_per_obj=64))
    _eq(t_syn.classification_set(seed, 6, 64, variant="hard"),
        j_syn.classification_set(seed, 6, 64, variant="hard"))
    _eq(t_syn.scenenn_scene(seed, num_objects=6, points_per_obj=32),
        j_syn.scenenn_scene(seed, num_objects=6, points_per_obj=32))


def test_s3dis_identical():
    room = t_syn.segmentation_scene(1, num_objects=3, points_per_obj=128)
    kw = dict(num_points=128, block_size=1.0, stride=0.5)
    a = t_s3dis.room_blocks(*room, rng=np.random.RandomState(0), **kw)
    b = j_s3dis.room_blocks(*room, rng=np.random.RandomState(0), **kw)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    pred = np.random.RandomState(2).randint(0, 5, len(room[2]))
    ma = t_s3dis.iou_metrics(pred, room[2], 5)
    mb = j_s3dis.iou_metrics(pred, room[2], 5)
    assert ma["accuracy"] == mb["accuracy"] and ma["miou"] == mb["miou"]


def test_gridhash_identical():
    assert t_native.available()
    # built into the port's own ignored build directory, not beside the source
    assert os.path.isdir(os.path.join(os.path.dirname(t_native.__file__),
                                      "_build"))
    rng = np.random.RandomState(4)
    pts = rng.uniform(-3, 5, (3000, 3)).astype(np.float32)
    gt, gj = t_native.GridIndex(pts, 0.9), j_native.GridIndex(pts, 0.9)
    np.testing.assert_array_equal(gt.nonempty_cells(), gj.nonempty_cells())
    for c in gt.nonempty_cells()[:10]:
        np.testing.assert_array_equal(gt.cell_points(c), gj.cell_points(c))
    lo, hi = np.float32([-1, 0, 1]), np.float32([2, 2.5, 3])
    np.testing.assert_array_equal(np.sort(gt.query_box(lo, hi)),
                                  np.sort(gj.query_box(lo, hi)))
    np.testing.assert_array_equal(t_native.morton_codes(pts),
                                  j_native.morton_codes(pts))


def test_numpy_fallback_matches_native():
    rng = np.random.RandomState(5)
    pts = rng.uniform(0, 4, (2000, 3)).astype(np.float32)
    g = t_native.GridIndex(pts, 1.1)
    starts, order = g.cell_starts.copy(), g.order.copy()
    g._build_np()
    np.testing.assert_array_equal(g.cell_starts, starts)
    np.testing.assert_array_equal(np.sort(g.order), np.sort(order))


def test_port_imports_no_jax():
    # a subprocess that blocks jax imports the port's entry modules; no jax,
    # flax or pointwise_tpu module may load, nor tensorstore (the orbax
    # reader imports it only when it reads)
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        root = name.split('.')[0]\n"
        "        if root in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                    'pointwise_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pointwise_torch, pointwise_torch.infer, "
        "pointwise_torch.streaming, pointwise_torch.convert, "
        "pointwise_torch.train.cli, pointwise_torch.train.trainer, "
        "pointwise_torch.models.classifier, pointwise_torch.data.augment, "
        "pointwise_torch.data.modelnet, pointwise_torch.data.pipeline, "
        "pointwise_torch.tools.export_checkpoint\n"
        "import runpy\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pointwise_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'tensorstore' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_cuda_is_the_default_and_cpu_is_explicit():
    import torch

    assert pointwise_torch.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pointwise_torch.resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pointwise_torch.resolve_device("cuda")


def test_modelnet_identical():
    from pointwise_torch.data import modelnet as t_mn
    from pointwise_tpu.data import modelnet as j_mn

    a = t_mn.load_modelnet40(None, "test", 64, synthetic_size=12, seed=2)
    b = j_mn.load_modelnet40(None, "test", 64, synthetic_size=12, seed=2)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.num_classes == b.num_classes
    for x, y in zip(t_mn.batches(a, 5, seed=3), j_mn.batches(b, 5, seed=3)):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_modelnet_h5_dir_needs_h5py(tmp_path, monkeypatch):
    from pointwise_torch.data import modelnet as t_mn

    (tmp_path / "ply_data_train0.h5").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)     # import fails
    with pytest.raises(RuntimeError, match="h5py"):
        t_mn.load_modelnet40(os.fspath(tmp_path), "train")


def test_augment_properties():
    import torch

    from pointwise_torch.data import augment

    pts = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (4, 100, 3)).astype(np.float32))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # jitter: the clip bound holds, and sigma sets the scale
    d = augment.jitter(pts, gen(0), sigma=0.05, clip=0.02) - pts
    assert float(d.abs().max()) <= 0.02 + 1e-7 and float(d.abs().max()) > 0
    # rotation about Y keeps norms and the Y coordinate
    r = augment.rotate_y(pts, gen(1))
    np.testing.assert_allclose(r.norm(dim=-1), pts.norm(dim=-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r[..., 1], pts[..., 1], atol=1e-6)
    assert not torch.allclose(r, pts)
    # one scale per cloud, in [0.8, 1.25)
    s = augment.random_scale(pts, gen(2)) / pts
    per_cloud = s.reshape(4, -1)
    assert torch.allclose(per_cloud, per_cloud[:, :1].expand_as(per_cloud))
    assert 0.8 <= float(s.min()) and float(s.max()) < 1.25
    # the same generator seed gives the same output, another seed another
    a = augment.classification_augment(pts, gen(5))
    assert torch.equal(a, augment.classification_augment(pts, gen(5)))
    assert not torch.equal(a, augment.classification_augment(pts, gen(6)))
    assert augment.classification_augment(pts[0], gen(5)).shape == (100, 3)


def test_prefetch_keeps_order_on_the_cpu():
    import torch

    from pointwise_torch.data import pipeline

    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    out = list(pipeline.prefetch_to_device(iter(batches),
                                           torch.device("cpu"), size=2))
    assert [int(b["x"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
