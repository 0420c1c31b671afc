"""ShapeNetPart part-segmentation dataset.

A port of pointwise_tpu/data/shapenetpart.py: clouds of single objects, a
16-way object category, and per-point part labels from a global label
space in which each category owns its parts.

On-disk contract: a directory of HDF5 shards with datasets ``data`` (B, N,
3), ``label`` (B, 1) category and ``pid`` (B, N) part ids (the public
release's layout, 50 parts).  Reading them needs ``h5py``, which the port
does not require: without it a directory of shards raises.  Without a
directory, procedural clouds stand in: primitive shapes whose parts are
angular sectors about the up axis, offset by the category, 3 per category
(48 parts; models take ``num_parts`` from the data, not the config).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterator

import numpy as np

from pointwise_torch.data import synthetic
from pointwise_torch.utils import spatial

NUM_CATEGORIES = 16
NUM_PARTS = 50
PARTS_PER_CATEGORY = 3  # synthetic stand-in: 3 sectors per category

# The public release's category -> global part ids (the ``seg_classes``
# table).  Instance mIoU averages each shape's IoU over its category's FULL
# part set (absent parts count as IoU 1.0), so the table is part of the
# metric.
REAL_PART_RANGES = {
    0: [0, 1, 2, 3],          # airplane
    1: [4, 5],                # bag
    2: [6, 7],                # cap
    3: [8, 9, 10, 11],        # car
    4: [12, 13, 14, 15],      # chair
    5: [16, 17, 18],          # earphone
    6: [19, 20, 21],          # guitar
    7: [22, 23],              # knife
    8: [24, 25, 26, 27],      # lamp
    9: [28, 29],              # laptop
    10: [30, 31, 32, 33, 34, 35],  # motorbike
    11: [36, 37],             # mug
    12: [38, 39, 40],         # pistol
    13: [41, 42, 43],         # rocket
    14: [44, 45, 46],         # skateboard
    15: [47, 48, 49],         # table
}


@dataclasses.dataclass
class PartSegData:
    points: np.ndarray      # (num, N, 3) f32
    category: np.ndarray    # (num,) i32 in [0, 16)
    part: np.ndarray        # (num, N) i32
    num_categories: int = NUM_CATEGORIES
    num_parts: int = NUM_PARTS
    # category -> this dataset's global part ids (drives instance mIoU)
    parts_per_category: dict | None = None


def _load_h5_dir(path: str, split: str) -> PartSegData | None:
    files = sorted(glob.glob(os.path.join(path, f"*{split}*.h5")))
    if not files:
        return None
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            f"{path} holds ShapeNetPart HDF5 shards but h5py is not "
            "installed; install h5py or omit the data directory (synthetic "
            "set)") from e
    pts, cats, pids = [], [], []
    for f in files:
        with h5py.File(f, "r") as h:
            pts.append(np.asarray(h["data"], np.float32))
            cats.append(np.asarray(h["label"], np.int64).reshape(-1))
            pids.append(np.asarray(h["pid"], np.int64))
    return PartSegData(
        spatial.check_coordinates(np.concatenate(pts), name=path),
        np.concatenate(cats).astype(np.int32),
        np.concatenate(pids).astype(np.int32),
        parts_per_category=REAL_PART_RANGES)


def _harden_partseg(rng: np.random.RandomState, p: np.ndarray) -> np.ndarray:
    """Deform one cloud and keep its canonical-frame part labels learnable:
    anisotropic scale, a bounded (+-20 deg) rotation about a random axis,
    surface jitter, ~2% outliers, then the unit sphere again."""
    p = p * rng.uniform(0.7, 1.4, 3)[None, :]
    axis = rng.normal(size=3)
    axis /= max(np.linalg.norm(axis), 1e-8)
    ang = rng.uniform(-np.pi / 9, np.pi / 9)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    p = p @ R.T
    p = p + rng.normal(0, 0.02, p.shape)
    n_out = max(1, len(p) // 50)                      # ~2% outliers
    idx = rng.choice(len(p), n_out, replace=False)
    p[idx] = rng.uniform(-1, 1, (n_out, 3))
    p = p - p.mean(axis=0, keepdims=True)
    return (p / max(np.linalg.norm(p, axis=1).max(), 1e-8)).astype(np.float32)


def synthetic_set(seed: int, num_clouds: int, n_points: int = 2048,
                  variant: str = "default") -> PartSegData:
    """The procedural stand-in: part = category * 3 + angular sector about
    the up (Y) axis, the sectors rotated per category.  ``variant='hard'``
    labels the canonical clouds, then deforms them (``_harden_partseg``)."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, NUM_CATEGORIES, num_clouds).astype(np.int32)
    pts = np.stack(
        [synthetic.make_shape(rng, int(c) % synthetic.NUM_CLASSES, n_points)
         for c in cats]).astype(np.float32)
    ang = np.arctan2(pts[..., 2], pts[..., 0]) + np.pi           # [0, 2pi)
    ang = (ang + (cats[:, None] * 2 * np.pi / NUM_CATEGORIES)) % (2 * np.pi)
    sector = np.minimum(
        (ang / (2 * np.pi) * PARTS_PER_CATEGORY).astype(np.int32),
        PARTS_PER_CATEGORY - 1)
    part = (cats[:, None] * PARTS_PER_CATEGORY + sector).astype(np.int32)
    if variant == "hard":
        pts = np.stack([_harden_partseg(rng, c) for c in pts])
    elif variant != "default":
        raise ValueError(f"unknown variant {variant!r}")
    return PartSegData(
        pts, cats, part, num_parts=NUM_CATEGORIES * PARTS_PER_CATEGORY,
        parts_per_category={
            c: list(range(c * PARTS_PER_CATEGORY,
                          (c + 1) * PARTS_PER_CATEGORY))
            for c in range(NUM_CATEGORIES)})


def load_shapenetpart(path: str | None, split: str = "train",
                      n_points: int = 2048, synthetic_size: int = 256,
                      seed: int = 0, variant: str = "default") -> PartSegData:
    """The shards of ``path`` when it holds some, the synthetic set (seed
    offset by 10,000 for the test split) otherwise; each cloud cut to
    ``n_points`` and morton-sorted."""
    if path:
        data = _load_h5_dir(path, split)
        if data is not None:
            if data.points.shape[1] > n_points:
                data.points = data.points[:, :n_points]
                data.part = data.part[:, :n_points]
            data.points, data.part = spatial.morton_sort_batch(
                data.points, data.part)
            return data
    seed = seed + (0 if split == "train" else 10_000)
    data = synthetic_set(seed, synthetic_size, n_points, variant=variant)
    data.points, data.part = spatial.morton_sort_batch(data.points, data.part)
    return data


def batches(data: PartSegData, batch_size: int, *, shuffle=True, seed=0,
            drop_remainder=True) -> Iterator[dict]:
    """Host-side epoch iterator of {'points', 'category', 'label', 'mask'}
    numpy batches."""
    n = len(data.category)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, stop, batch_size):
        sel = idx[s:s + batch_size]
        yield {"points": data.points[sel],
               "category": data.category[sel],
               "label": data.part[sel],
               "mask": np.ones((len(sel), data.points.shape[1]), np.float32)}


def category_miou(pred: np.ndarray, label: np.ndarray, category: np.ndarray,
                  parts_per_category: dict | None = None) -> float:
    """Instance-average mIoU, the ShapeNetPart convention: each shape's IoU
    averaged over its category's FULL part set (absent parts score 1.0),
    then over shapes.  ``parts_per_category`` is the dataset's mapping
    (``PartSegData.parts_per_category``); without it each shape falls back
    to its own present or predicted parts, which scores at most the
    convention."""
    ious = []
    for i in range(len(category)):
        if parts_per_category is None:
            parts = np.unique(np.concatenate([label[i], pred[i]]))
        else:
            parts = parts_per_category[int(category[i])]
        shape_ious = []
        for p in parts:
            inter = int(((pred[i] == p) & (label[i] == p)).sum())
            union = int(((pred[i] == p) | (label[i] == p)).sum())
            shape_ious.append(1.0 if union == 0 else inter / union)
        ious.append(float(np.mean(shape_ious)))
    return float(np.mean(ious))
