"""The traffic generator: inputs of every cell, made from ``--seed``.

A traffic mix is a JSON file under benchmark/traffic/ that this module
reads; its ``kind`` names the loop that runs it (``serve`` or ``train``)
and, for training, its ``data`` names the input family (``room_blocks`` or
``clouds``).  The same seed gives the same inputs; every seed gives the
same sizes.
"""

from __future__ import annotations

import json
import os
import types

import numpy as np

from benchmark.frozen import blocks as frozen_blocks
from benchmark.frozen import synthetic
from benchmark.frozen.spatial import morton_sort_batch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    """The traffic mix ``name`` (benchmark/traffic/<name>.json)."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from ``seed`` and ``keys``."""
    return int(np.random.SeedSequence([int(seed), *keys])
               .generate_state(1)[0])


# ---- served scans ------------------------------------------------------

def base_scenes(cfg: dict, traffic: dict, seed: int) -> list:
    """``traffic["base_scenes"]`` procedural rooms of about
    ``traffic["scene_points"]`` points each, [(xyz, rgb)], in an order
    drawn from ``seed``.  The rooms themselves come from
    ``traffic["rooms_seed"]``: every seed serves the same rooms, in other
    orders and turns."""
    out = []
    for b in range(traffic["base_scenes"]):
        xyz, rgb, _ = synthetic.big_scene(
            traffic["scene_points"], seed=sub_seed(traffic["rooms_seed"], 3, b),
            num_classes=cfg["num_classes"])
        out.append((xyz.astype(np.float32), rgb))
    order = np.random.default_rng([int(seed), 3]).permutation(len(out))
    return [out[b] for b in order]


def scan_request(cfg: dict, traffic: dict, scenes: list, seed: int,
                 index: int, warm: bool = False):
    """Request ``index`` (a warm-up request when ``warm``): base scene
    ``index`` mod their number, turned by a uniform angle about the up (z)
    axis around the room's middle, moved by a uniform offset of up to
    ``traffic["translate_m"]`` in x and y, in float32.
    Returns (xyz, features) f32, the features as the model's training
    convention makes them."""
    rng = np.random.default_rng([int(seed), 2 if warm else 1, int(index)])
    xyz, rgb = scenes[index % len(scenes)]
    theta = rng.uniform(0.0, 2.0 * np.pi)
    shift = rng.uniform(-1.0, 1.0, 2) * traffic["translate_m"]
    c, s = np.float32(np.cos(theta)), np.float32(np.sin(theta))
    mid = (xyz.min(0) + xyz.max(0)) / 2
    x, y = xyz[:, 0] - mid[0], xyz[:, 1] - mid[1]
    moved = np.empty_like(xyz)
    moved[:, 0] = c * x - s * y + np.float32(mid[0] + shift[0])
    moved[:, 1] = s * x + c * y + np.float32(mid[1] + shift[1])
    moved[:, 2] = xyz[:, 2]
    feats = synthetic.scene_features(cfg["in_features"], moved, rgb)
    return moved, feats.astype(np.float32, copy=False)


# ---- training batches --------------------------------------------------

def batch_pool(cfg: dict, traffic: dict, seed: int) -> list:
    """``traffic["pool_batches"]`` distinct training batches (numpy dicts
    in the program's batch format), cycled by the training loop.  Blocks come
    from the rooms of ``traffic["rooms_seed"]``, the points sampled into
    each block and the blocks of each batch from ``seed``."""
    make = {"room_blocks": _block_pool, "clouds": _cloud_pool}
    return make[traffic["data"]](cfg, traffic, seed)


def _block_pool(cfg, traffic, seed):
    rooms = []
    for r in range(traffic["rooms"]):
        xyz, rgb, lab = synthetic.big_scene(
            traffic["room_points"], seed=sub_seed(traffic["rooms_seed"], 4, r),
            num_classes=cfg["num_classes"])
        rooms.append((xyz.astype(np.float32), rgb, lab))

    blocks = frozen_blocks.training_blocks(
        types.SimpleNamespace(**cfg), rooms, seed=sub_seed(seed, 5))
    bs, n = cfg["batch_size"], traffic["pool_batches"]
    if len(blocks["points"]) < bs * n:
        raise ValueError(f"{len(blocks['points'])} blocks, fewer than "
                         f"{n} batches of {bs}")
    idx = np.random.default_rng([int(seed), 6]).permutation(
        len(blocks["points"]))[:bs * n]
    return [{k: blocks[k][idx[i * bs:(i + 1) * bs]]
             for k in ("points", "features", "label", "mask")}
            for i in range(n)]


def _cloud_pool(cfg, traffic, seed):
    bs, n = cfg["batch_size"], traffic["pool_batches"]
    clouds, _ = synthetic.classification_set(sub_seed(seed, 7), bs * n,
                                             cfg["num_points"])
    clouds = morton_sort_batch(clouds)
    labels = np.random.default_rng([int(seed), 8]).integers(
        0, cfg["num_classes"], bs * n).astype(np.int32)
    return [{"points": clouds[i * bs:(i + 1) * bs],
             "label": labels[i * bs:(i + 1) * bs]} for i in range(n)]
