"""S3DIS-style scene segmentation pipeline: sliding blocks + overlap voting.

Rebuild of SURVEY.md C8 / BASELINE.json config 3: large indoor scans are
cropped into fixed-size XY blocks (4096 points each), each block is a
static-shape training example, and at inference overlapping block
predictions are vote-merged back onto the full scene (per-point argmax over
summed logits) — semantics preserved bit-for-bit from the reference flow
(SURVEY.md section 3.3) while every block batch stays a static padded shape
for XLA.

On-disk contract for real data: ``data_dir`` holding ``*.npy`` rooms, each
(N, 7) = xyz, rgb in [0,255] or [0,1], integer label.  Without a data dir
the procedural scenes from data/synthetic.py are used.

Block features follow the reference convention (SURVEY.md section 0.2):
rgb (3) + room-normalized coordinates (3); the conv geometry input is the
block-centered xyz.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Iterator

import numpy as np

from pointwise_torch import native
from pointwise_torch.data import synthetic
from pointwise_torch.utils.runtime import span
from pointwise_torch.utils.spatial import check_coordinates, morton_code


def load_rooms(data_dir: str | None, *, synthetic_rooms: int = 4, seed: int = 0):
    """Returns list of (xyz (N,3) f32, rgb (N,3) f32 in [0,1], label (N,) i32)."""
    rooms = []
    if data_dir:
        for f in sorted(glob.glob(os.path.join(data_dir, "**", "*.npy"), recursive=True)):
            arr = np.load(f)
            if arr.ndim != 2 or arr.shape[1] < 7:
                continue
            xyz = check_coordinates(arr[:, 0:3].astype(np.float32), name=f)
            rgb = arr[:, 3:6].astype(np.float32)
            if rgb.max() > 1.5:
                rgb = rgb / 255.0
            rooms.append((xyz, rgb, arr[:, 6].astype(np.int32)))
    if not rooms:
        for i in range(synthetic_rooms):
            rooms.append(synthetic.segmentation_scene(seed + i))
    return rooms


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
    return _crop(xyz, rgb, label, num_points=num_points,
                 block_size=block_size, stride=stride, min_points=min_points,
                 rng=rng, cover_all=cover_all, feature_mode=feature_mode)[0]


def _crop(xyz, rgb, label, *, num_points, block_size, stride, rng,
          cover_all, feature_mode, min_points=32):
    """``room_blocks``' dict (None without a block) and the chunks the
    native pass emitted (``native.crop_chunks``; 0 on the NumPy path,
    which float32 rooms take only without the library)."""
    rng = rng or np.random.RandomState(0)
    mins, maxs = xyz.min(0), xyz.max(0)
    span = np.maximum(maxs - mins, 1e-6)
    xs = np.arange(mins[0], maxs[0] + 1e-6, stride)
    ys = np.arange(mins[1], maxs[1] + 1e-6, stride)
    column = _columns(xyz, mins, stride, block_size)
    rows, corners = [], []
    for x0 in xs:
        members = column(x0)
        for y0 in ys:
            sel = members(y0)
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
            rows += chunks
            corners += [(x0, y0)] * len(chunks)
    if not rows:
        return None, 0
    if xyz.dtype == np.float32 and native.available():
        centers = np.array([(x0 + block_size / 2, y0 + block_size / 2)
                            for x0, y0 in corners], np.float32)
        return native.crop_chunks(xyz, rgb, label, mins, span, np.stack(rows),
                                  centers, feature_mode != "rgb"), len(rows)
    out = {k: [] for k in ("points", "features", "label", "mask", "index")}
    for sel, (x0, y0) in zip(rows, corners):
        _emit_block(out, xyz, rgb, label, sel, x0, y0,
                    block_size, mins, span, feature_mode)
    return {k: np.stack(v) for k, v in out.items()}, 0


def _columns(xyz, mins, stride, block_size):
    """``column(x0)(y0)``: the points of the window [x0, x0 + block_size)
    x [y0, y0 + block_size), in ascending order, as ``np.where`` over the
    whole room gives them.  The points are binned once into square cells
    of side ``stride`` from ``mins``, and a window tests only the cells it
    can touch, widened by one on each side, with the comparisons of a
    whole-room scan: ``column(x0)`` makes the x test on the strip of cells
    of its windows and sorts the strip by y cell, then each window makes
    the y test on one run of the strip."""
    x, y = xyz[:, 0], xyz[:, 1]
    m0, m1 = float(mins[0]), float(mins[1])

    def cells(v, m):
        return np.floor((v.astype(np.float64) - m) / stride).astype(np.int64)

    def reach(v0, m, n):          # the cells a window from v0 can touch
        return (max(math.floor((v0 - m) / stride) - 1, 0),
                min(math.floor((v0 + block_size - m) / stride) + 1, n - 1))

    ix, iy = cells(x, m0), cells(y, m1)
    nx, ny = int(ix.max()) + 1, int(iy.max()) + 1
    by_x = np.argsort(ix, kind="stable")
    col = np.searchsorted(ix[by_x], np.arange(nx + 1))

    def column(x0):
        a, b = reach(x0, m0, nx)
        idx = by_x[col[a]:col[max(a, b + 1)]]
        idx = idx[(x[idx] >= x0) & (x[idx] < x0 + block_size)]
        idx = idx[np.argsort(iy[idx], kind="stable")]
        ys, row = y[idx], np.searchsorted(iy[idx], np.arange(ny + 1))

        def members(y0):
            a, b = reach(y0, m1, ny)
            run = slice(row[a], row[max(a, b + 1)])
            return np.sort(
                idx[run][(ys[run] >= y0) & (ys[run] < y0 + block_size)])

        return members

    return column


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


def training_blocks(cfg, data_dir: str | None = None, seed: int = 0,
                    rooms=None):
    """Blocks from ``rooms`` (or from ``data_dir``/synthetic when None) —
    pass an explicit room list to build disjoint train/heldout splits at
    ROOM level (overlapping-stride blocks from one room share points, so a
    block-level split leaks eval points into training)."""
    if rooms is None:
        rooms = load_rooms(data_dir, seed=seed)
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


def block_batches(blocks: dict, batch_size: int, *, shuffle=True, seed=0,
                  drop_remainder=True) -> Iterator[dict]:
    n = len(blocks["points"])
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, stop, batch_size):
        sel = idx[s : s + batch_size]
        yield {k: v[sel] for k, v in blocks.items() if k != "index"}


def predict_scene_voting(
    predict_logits,
    xyz: np.ndarray,
    rgb: np.ndarray,
    *,
    num_classes: int,
    num_points: int,
    block_size: float = 1.0,
    stride: float = 0.5,
    batch_size: int = 16,
    label: np.ndarray | None = None,
    rng: np.random.RandomState | None = None,
    feature_mode: str = "rgb_norm",
    events: dict | None = None,
):
    """Full-scene inference with overlap voting (SURVEY.md section 3.3).

    predict_logits(points (B,N,3), features (B,N,C), mask (B,N)) -> (B,N,K).
    Votes = sum of logits per original point over all overlapping blocks;
    final label = argmax of votes.  Points never covered by any block get
    class 0 and are reported in `uncovered`.

    Its three phases are spans (``runtime.span``): ``vote.crop`` (the
    blocks), ``vote.forward`` (each ``predict_logits`` call, its fetch to
    the host included) and ``vote.scatter`` (adding each block's logits
    into the votes).  ``events``, when given, gains their seconds under
    ``crop_s``, ``forward_s`` and ``scatter_s``, ``chunks`` (the blocks
    ``room_blocks`` emitted), ``crop_native`` (those of them the native
    pass emitted: all or 0) and ``pad_chunks`` (the rows repeated to fill
    the last batch).
    """
    ev = {"crop_s": 0.0, "forward_s": 0.0, "scatter_s": 0.0}
    with span("vote.crop", ev, "crop_s"):
        blocks, ev["crop_native"] = _crop(
            xyz, rgb,
            label if label is not None else np.zeros(len(xyz), np.int32),
            num_points=num_points, block_size=block_size, stride=stride,
            rng=rng or np.random.RandomState(0), cover_all=True,
            feature_mode=feature_mode,
        )
    votes = np.zeros((len(xyz), num_classes), np.float32)
    covered = np.zeros(len(xyz), bool)
    nb = 0 if blocks is None else len(blocks["points"])
    for s in range(0, nb, batch_size):
        e = min(s + batch_size, nb)
        pad = batch_size - (e - s)
        feed = {
            k: np.concatenate([v[s:e], np.repeat(v[e - 1 : e], pad, 0)])
            if pad else v[s:e]
            for k, v in blocks.items()
        }
        with span("vote.forward", ev, "forward_s"):
            logits = np.asarray(
                predict_logits(feed["points"], feed["features"], feed["mask"])
            )[: e - s]
        with span("vote.scatter", ev, "scatter_s"):
            for bi in range(e - s):
                idx = blocks["index"][s + bi]
                np.add.at(votes, idx, logits[bi])
                covered[idx] = True
    if events is not None:
        events.update(ev, chunks=nb, pad_chunks=-nb % batch_size)
    pred = votes.argmax(axis=1).astype(np.int32)
    return {"pred": pred, "votes": votes, "covered": covered}


def iou_metrics(pred: np.ndarray, label: np.ndarray, num_classes: int):
    """Overall accuracy + per-class IoU + mIoU (the reference's eval metrics)."""
    from pointwise_torch.utils.metrics import segmentation_metrics

    m = segmentation_metrics(pred, label, num_classes)
    return {"accuracy": m["accuracy"], "miou": m["miou"],
            "per_class_iou": m["per_class_iou"],
            "mean_class_accuracy": m["mean_class_accuracy"]}
