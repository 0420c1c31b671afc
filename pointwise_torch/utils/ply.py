"""Minimal PLY writer for prediction visualization.

The reference repo family ships viewers/exports for predicted per-point
labels (SURVEY.md C11 eval flows end in per-point labels); this is the
rebuild's equivalent: write a scene's points with per-class colors (or raw
rgb) as a binary little-endian PLY that any standard viewer opens.  The
format mirrors what ``scripts/prepare_scenenn.read_ply_vertices`` parses,
so exports round-trip through the in-repo reader (tested).
"""

from __future__ import annotations

import numpy as np

# 20 visually-distinct class colors (repeats beyond 20); label -1 = gray.
_PALETTE = np.asarray([
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
], np.uint8)


def label_colors(labels: np.ndarray) -> np.ndarray:
    """(N,) int labels -> (N, 3) uint8 palette colors (-1 = mid gray)."""
    labels = np.asarray(labels)
    rgb = _PALETTE[np.abs(labels) % len(_PALETTE)]
    return np.where((labels < 0)[:, None], np.uint8(160), rgb)


def write_ply(path: str, xyz: np.ndarray, *, colors: np.ndarray | None = None,
              labels: np.ndarray | None = None) -> None:
    """Write points (+ colors and/or labels) as binary little-endian PLY.

    xyz (N, 3) float; colors (N, 3) uint8 or float in [0, 1]; labels (N,)
    int (written as an int32 'label' property AND, when no explicit colors
    are given, rendered through the class palette).
    """
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    props = ["property float x", "property float y", "property float z"]
    if colors is None and labels is not None:
        colors = label_colors(labels)
    if colors is not None:
        colors = np.asarray(colors)
        if np.issubdtype(colors.dtype, np.integer):
            colors = np.clip(colors, 0, 255).astype(np.uint8)   # 0-255 ints
        elif colors.dtype != np.uint8:
            # floats in [0, 1]; round (not truncate) so values round-trip
            colors = np.rint(np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    if labels is not None:
        fields.append(("label", "<i4"))
        props.append("property int label")

    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2])
    if labels is not None:
        rec["label"] = np.asarray(labels, np.int32)

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"] + props + ["end_header", ""]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
