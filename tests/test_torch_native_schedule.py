"""The streaming engine's native schedule build, on the CPU.

``native.presort`` and ``GridIndex.nested_schedule`` must give the same bits
as the NumPy path they replace (``np.argsort`` of ``morton_codes``, the
gathers, ``streaming._nested_candidates``), and the engine's output must not
depend on whether the native library loaded.
"""

import numpy as np
import pytest
import torch

from pointwise_torch import native, streaming
from pointwise_torch.infer import layered_apply
from pointwise_torch.models import PointwiseSegmenter
from pointwise_torch.native import GridIndex

TILE = 1.7                          # 1 / TILE is not exact in float32
HALOS = (1.0, 0.6, 0.25)            # box 0 the outermost, as the engine's
RADII = (0.25, 0.5)
KW = dict(radii=RADII, tile_size=TILE, out_dim=5, buckets=(256, 512, 1024),
          tile_batch=2)


def _boxes(grid, c, halos):
    """The engine's tile box and its halo boxes for grid cell ``c``."""
    lo = grid.origin + c.astype(np.float32) * TILE
    hi = lo + TILE
    return lo, hi, [lo - h for h in halos], [hi + h + 1e-5 for h in halos]


def _faces(halos):
    """Coordinates on the tile seams and on the halo boxes' faces of the
    cells at 1 and 2 (origin 0), with their float32 neighbours."""
    v = [np.float32(k) * np.float32(TILE) for k in range(5)]
    for k in (1, 2):
        lo = np.float32(k) * TILE
        hi = lo + TILE
        v += [lo - h for h in halos] + [hi + h + 1e-5 for h in halos]
    v = np.asarray(v, np.float32)
    return np.concatenate([v, np.nextafter(v, np.float32(-1)),
                           np.nextafter(v, np.float32(9))])


def _seams(rng):
    """Points with one, two or three coordinates on a seam or a face."""
    faces = _faces(HALOS + tuple(sum(RADII[l:]) for l in range(len(RADII))))
    m = 800
    pts = rng.uniform(0, 6, (m, 3)).astype(np.float32)
    for q, axes in enumerate(((0,), (1,), (2,), (0, 1), (0, 1, 2))):
        rows = slice(q * m // 5, (q + 1) * m // 5)
        for a in axes:
            pts[rows, a] = rng.choice(faces, m // 5)
    pts[0] = 0.0                    # origin 0, so the faces are the boxes'
    return pts


def _scene(name):
    rng = np.random.default_rng(SCENES.index(name))
    if name == "uniform":
        pts = rng.uniform(0, 7, (700, 3)) * [1, 1, 0.4]
    elif name == "uniform_threads":       # the presort's threaded passes
        pts = rng.uniform(0, 7, (70_000, 3)) * [1, 1, 0.4]
    elif name == "duplicated":
        base = rng.uniform(0, 5, (200, 3))
        pts = rng.permutation(np.repeat(base, 3, axis=0))
    elif name == "seams":
        pts = _seams(rng)
    elif name == "one_cell":
        pts = rng.uniform(0, 1.5, (400, 3))
    elif name == "flat_z":
        pts = rng.uniform(0, 6, (600, 3))
        pts[:, 2] = 0.7
    elif name == "empty_cells":
        a = rng.uniform(0, 2, (300, 3))
        b = rng.uniform(0, 2, (300, 3)) + [8, 8, 0]
        c = rng.uniform(0, 1, (50, 3)) + [0, 9, 0.5]
        pts = rng.permutation(np.concatenate([a, b, c]))
    pts = np.asarray(pts, np.float32)
    feats = rng.normal(size=(len(pts), 3)).astype(np.float32)
    return pts, feats


SCENES = ("uniform", "uniform_threads", "duplicated", "seams", "one_cell",
          "flat_z", "empty_cells")
SERVED = tuple(s for s in SCENES if s != "uniform_threads")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _numpy_presort(xyz, feats):
    order = np.argsort(native.morton_codes(xyz), kind="stable")
    return order, xyz[order], feats[order], xyz.min(axis=0), xyz.max(axis=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SCENES)
def test_presort_matches_numpy(monkeypatch, name):
    assert native.available()
    xyz, feats = _scene(name)
    want = _numpy_presort(xyz, feats)
    got = native.presort(xyz, feats)
    monkeypatch.setattr(native, "_lib", False)
    fallback = native.presort(xyz, feats)
    for res in (got, fallback):
        order, sx, sf, lo, hi = res
        assert order.dtype == np.int64
        np.testing.assert_array_equal(order, want[0])
        for a, b in zip((sx, sf, lo, hi), want[1:]):
            assert a.dtype == np.float32 and a.flags.c_contiguous
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", SCENES)
def test_schedule_matches_nested_candidates(name):
    xyz, feats = _scene(name)
    _, sx, _, lo_all, hi_all = native.presort(xyz, feats)
    grid = GridIndex(sx, TILE, bbox=(lo_all, hi_all))
    plain = GridIndex(sx, TILE)
    for a in ("origin", "dims", "cell_starts", "order"):
        np.testing.assert_array_equal(getattr(grid, a), getattr(plain, a))
    depth = np.zeros(len(sx), np.uint8)
    cells = grid.nonempty_cells()
    for halos in (HALOS, HALOS[:1]):
        for c in cells:
            lo, hi, box_lo, box_hi = _boxes(grid, c, halos)
            want = streaming._nested_candidates(grid, c, lo, hi, halos)
            got = grid.nested_schedule(c, box_lo, box_hi, depth)
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            for lists_got, lists_want in zip(got[3:], want[3:]):
                assert len(lists_got) == len(lists_want) == len(halos)
                for a, b in zip(lists_got, lists_want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            assert not depth.any()      # left zero for the thread's next tile
    if name == "one_cell":
        assert len(cells) == 1
    if name == "empty_cells":
        assert len(cells) < int(np.prod(grid.dims))


@pytest.mark.parametrize("xyz_shape, feats_shape", [
    ((5, 3), (4, 3)), ((5, 2), (5, 3)), ((5, 3), (5,)), ((0, 3), (0, 3))])
def test_presort_refuses_bad_shapes(xyz_shape, feats_shape):
    with pytest.raises(ValueError):
        native.presort(np.zeros(xyz_shape, np.float32),
                       np.zeros(feats_shape, np.float32))


def test_schedule_refuses_a_short_depth_buffer():
    xyz, _ = _scene("uniform")
    grid = GridIndex(xyz, TILE)
    c = grid.nonempty_cells()[0]
    _, _, box_lo, box_hi = _boxes(grid, c, HALOS)
    with pytest.raises(ValueError):
        grid.nested_schedule(c, box_lo, box_hi,
                             np.zeros(len(xyz) - 1, np.uint8))


@pytest.fixture(scope="module")
def model():
    return PointwiseSegmenter(5, 3, channels=(8, 8), radii=RADII,
                              head_dims=(16,), dropout_rate=0.0,
                              precision="float32", use_global_context=False,
                              device="cpu").eval()


@pytest.mark.parametrize("name", SERVED)
def test_served_bits_without_the_library(monkeypatch, model, name):
    xyz, feats = _scene(name)

    def serve(events):
        return streaming.stream_apply_layered(
            layered_apply(model), xyz, feats, device="cpu", events=events,
            **KW)

    ev_native, ev_numpy = {}, {}
    with torch.no_grad():
        out = serve(ev_native)
        monkeypatch.setattr(native, "_lib", False)
        assert not native.available()
        out_numpy = serve(ev_numpy)
    np.testing.assert_array_equal(_bits(out), _bits(out_numpy))
    assert np.isfinite(out).all() and out.any(axis=1).all()
    assert ev_native["n_jobs"] == ev_numpy["n_jobs"] >= 1
    assert ev_native["schedule_native"] == ev_native["n_jobs"]
    assert ev_numpy["schedule_native"] == 0
