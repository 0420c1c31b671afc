"""Procedural part-segmentation shapes.

``REAL_PART_RANGES`` is copied from pointwise_torch/data/shapenetpart.py
at commit 3bc7660; ``part_set`` follows that file's ``synthetic_set`` (the
unit-sphere primitive of ``category % 10``, parts as angular sectors
about the up axis turned by the category) with each category's own
published part list in place of its three synthetic sectors, and sorts
every shape in Z-order with its labels as ``load_shapenetpart`` does.
"""

from __future__ import annotations

import numpy as np

from benchmark.frozen.spatial import morton_sort_batch
from benchmark.frozen.synthetic import NUM_CLASSES, make_shape

NUM_CATEGORIES = 16

# the public release's category -> global part ids (50 parts)
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


def part_set(seed: int, num_shapes: int, n_points: int):
    """(points (num, n, 3) f32, category (num,) i32, part (num, n) i32):
    categories drawn uniformly from ``seed`` (a 32-bit seed), each point's
    part the sector of its angle about the up (y) axis among its
    category's parts."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, NUM_CATEGORIES, num_shapes).astype(np.int32)
    pts = np.stack([make_shape(rng, int(c) % NUM_CLASSES, n_points)
                    for c in cats]).astype(np.float32)
    ang = np.arctan2(pts[..., 2], pts[..., 0]) + np.pi           # [0, 2pi)
    ang = (ang + (cats[:, None] * 2 * np.pi / NUM_CATEGORIES)) % (2 * np.pi)
    part = np.empty(pts.shape[:2], np.int32)
    for i, c in enumerate(cats):
        parts = np.asarray(REAL_PART_RANGES[int(c)], np.int32)
        sector = np.minimum((ang[i] / (2 * np.pi) * len(parts)).astype(
            np.int32), len(parts) - 1)
        part[i] = parts[sector]
    pts, part = morton_sort_batch(pts, part)
    return pts, cats, part
