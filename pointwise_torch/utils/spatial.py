"""Spatial ordering utilities.

The conv kernels walk (center-tile, candidate-tile) pairs and skip pairs
whose bounding boxes are farther apart than the kernel radius.
That early-out only pays off when nearby points share tiles, so data loaders
sort each cloud by a coarse Morton (Z-order) key once on the host.  The op
itself is permutation-equivariant; only the point/feature/label ordering
changes, never results.
"""

from __future__ import annotations

import numpy as np


# The conv kernels mark padding with sentinel coordinates at ±1e6 (see
# ops/pointwise_conv.py); traced sentinel-collision validation is opt-in
# (compile-cache reasons), so real-data loaders call this cheap host-side
# guard instead — un-normalized inputs fail loudly at load time.
COORD_LIMIT = 5.0e5


def check_coordinates(xyz: np.ndarray, name: str = "points") -> np.ndarray:
    """Host-side (non-traced) guard: coordinates must stay far from the
    kernels' padding sentinel (±1e6) and be finite.  Returns ``xyz``."""
    xyz = np.asarray(xyz)
    if not np.all(np.isfinite(xyz)):
        raise ValueError(f"{name}: non-finite coordinates in input data")
    amax = float(np.abs(xyz).max()) if xyz.size else 0.0
    if amax >= COORD_LIMIT:
        raise ValueError(
            f"{name}: |coordinate| max {amax:.3g} >= {COORD_LIMIT:.0e} "
            "collides with the conv kernels' padding sentinel (1e6) — "
            "normalize/recenter the scene before feeding it"
        )
    return xyz


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x.astype(np.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order key per point. points (N, 3) -> uint32 (N,)."""
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-9)
    q = ((points - lo) / span * ((1 << bits) - 1)).astype(np.uint32)
    return (_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1) | _part1by2(q[:, 2])


def morton_sort(points: np.ndarray, *extras):
    """Sort one cloud (N,3) and aligned arrays by Z-order. Returns sorted copies."""
    perm = np.argsort(morton_code(points), kind="stable")
    out = (points[perm], *[e[perm] for e in extras])
    return out if extras else out[0]


def morton_sort_batch(points: np.ndarray, *extras):
    """Sort each cloud of a batch (B,N,3) independently."""
    outs = [morton_sort(points[b], *[e[b] for e in extras])
            for b in range(points.shape[0])]
    if not extras:
        return np.stack(outs)
    return tuple(np.stack([o[i] for o in outs]) for i in range(1 + len(extras)))
