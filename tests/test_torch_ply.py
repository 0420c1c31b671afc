"""The port's PLY writer (``infer --save-ply``) against the JAX package's.

``write_ply`` must write the same bytes for xyz alone, with colors (0-255
integers and floats in [0, 1]), with labels and with both, and
``label_colors`` must give the same colors for labels past the palette and
for the gray of label -1.
"""

import numpy as np
import pytest

from pointwise_torch.utils import ply as t_ply
from pointwise_tpu.utils import ply as j_ply

N = 37


def _inputs(kind):
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-5.0, 5.0, (N, 3)).astype(np.float64)
    kw = {}
    if kind in ("int_colors", "labels_and_colors"):
        kw["colors"] = rng.randint(-20, 300, (N, 3))
    if kind == "float_colors":
        kw["colors"] = rng.uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
    if kind in ("labels", "labels_and_colors"):
        kw["labels"] = rng.randint(-1, 45, N)
    return xyz, kw


@pytest.mark.parametrize("kind", ["xyz", "int_colors", "float_colors",
                                  "labels", "labels_and_colors"])
def test_write_ply_writes_the_jax_bytes(kind, tmp_path):
    xyz, kw = _inputs(kind)
    t_ply.write_ply(str(tmp_path / "t.ply"), xyz, **kw)
    j_ply.write_ply(str(tmp_path / "j.ply"), xyz, **kw)
    got = (tmp_path / "t.ply").read_bytes()
    assert got == (tmp_path / "j.ply").read_bytes()
    header, body = got.split(b"end_header\n")
    assert f"element vertex {N}".encode() in header
    width = 12 + 3 * ("colors" in kw or "labels" in kw) + 4 * ("labels" in kw)
    assert len(body) == N * width


def test_label_colors_past_the_palette():
    labels = np.asarray([-1, 0, 19, 20, 21, 39, 40, 1000, -1])
    got = t_ply.label_colors(labels)
    np.testing.assert_array_equal(got, j_ply.label_colors(labels))
    assert got.dtype == np.uint8 and got.shape == (len(labels), 3)
    np.testing.assert_array_equal(got[[0, -1]], 160)     # -1: mid gray
    np.testing.assert_array_equal(got[3], got[1])        # repeats past 20
    np.testing.assert_array_equal(got[7], got[1])        # 1000 % 20 == 0
