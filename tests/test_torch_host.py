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
    # flax or pointwise_tpu module may load
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
        "pointwise_torch.streaming, pointwise_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pointwise_tpu'))\n"
        "assert not bad, bad\n"
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
