"""Sliding 1 m training blocks cropped from rooms.

Copied from pointwise_torch/data/s3dis.py at commit 79480e8
(``room_blocks``, ``_emit_block``, ``training_blocks``, the last taking
its rooms as an argument instead of loading them).
"""

from __future__ import annotations

import numpy as np

from benchmark.frozen.spatial import morton_code


def room_blocks(
    xyz: np.ndarray,
    rgb: np.ndarray,
    label: np.ndarray,
    *,
    num_points: int,
    block_size: float = 1.0,
    stride: float = 0.5,
    min_points: int = 32,
    rng: np.random.RandomState | None = None,
    cover_all: bool = False,
    feature_mode: str = "rgb_norm",   # 'rgb_norm' (S3DIS, 6) | 'rgb' (SceneNN, 3)
):
    """Slide an XY window over one room -> static-shape block samples.

    Returns dict of stacked arrays:
      points   (B, num_points, 3)  block-centered xyz
      features (B, num_points, 6)  rgb + room-normalized coords
      label    (B, num_points)     per-point class
      mask     (B, num_points)     1 = real point
      index    (B, num_points)     index into the room's point array (-1 pad)
    """
    rng = rng or np.random.RandomState(0)
    mins, maxs = xyz.min(0), xyz.max(0)
    span = np.maximum(maxs - mins, 1e-6)
    out = {k: [] for k in ("points", "features", "label", "mask", "index")}
    xs = np.arange(mins[0], maxs[0] + 1e-6, stride)
    ys = np.arange(mins[1], maxs[1] + 1e-6, stride)
    for x0 in xs:
        for y0 in ys:
            sel = np.where(
                (xyz[:, 0] >= x0) & (xyz[:, 0] < x0 + block_size)
                & (xyz[:, 1] >= y0) & (xyz[:, 1] < y0 + block_size)
            )[0]
            if len(sel) < min_points:
                continue
            if len(sel) >= num_points and not cover_all:
                chunks = [rng.choice(sel, num_points, replace=False)]
            else:
                # cover every point: shuffle, split into num_points chunks,
                # pad the tail chunk by resampling (reference eval semantics:
                # all points of a block receive a prediction).
                sel = rng.permutation(sel)
                chunks = [
                    sel[s : s + num_points] for s in range(0, len(sel), num_points)
                ]
                tail = chunks[-1]
                if len(tail) < num_points:
                    pad = rng.choice(sel, num_points - len(tail), replace=True)
                    chunks[-1] = np.concatenate([tail, pad])
            for sel in chunks:
                _emit_block(out, xyz, rgb, label, sel, x0, y0,
                            block_size, mins, span, feature_mode)
    if not out["points"]:
        return None
    return {k: np.stack(v) for k, v in out.items()}


def _emit_block(out, xyz, rgb, label, sel, x0, y0, block_size, mins, span,
                feature_mode="rgb_norm"):
    # Morton-sort the block so the conv kernels' tile bbox early-out fires.
    sel = sel[np.argsort(morton_code(xyz[sel]), kind="stable")]
    mask = np.ones(len(sel), np.float32)
    bxyz = xyz[sel]
    center = np.array([x0 + block_size / 2, y0 + block_size / 2, 0.0], np.float32)
    local = bxyz - center
    if feature_mode == "rgb":
        feats = rgb[sel]
    else:
        norm_coords = (bxyz - mins) / span
        feats = np.concatenate([rgb[sel], norm_coords], axis=1)
    out["points"].append(local.astype(np.float32))
    out["features"].append(feats.astype(np.float32))
    out["label"].append(label[sel].astype(np.int32))
    out["mask"].append(mask)
    out["index"].append(sel.astype(np.int32))


def training_blocks(cfg, rooms, seed: int = 0):
    """Blocks of every room of ``rooms``; ``cfg`` needs num_points,
    block_size, block_stride and in_features."""
    rng = np.random.RandomState(seed)
    parts = []
    for xyz, rgb, lab in rooms:
        b = room_blocks(
            xyz, rgb, lab,
            num_points=cfg.num_points,
            block_size=cfg.block_size,
            stride=cfg.block_stride,
            rng=rng,
            feature_mode="rgb" if cfg.in_features == 3 else "rgb_norm",
        )
        if b is not None:
            parts.append(b)
    if not parts:
        raise ValueError("no blocks produced — check data_dir / block params")
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
