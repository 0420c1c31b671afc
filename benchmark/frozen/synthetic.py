"""Procedural clouds and rooms.

Copied from pointwise_torch/data/synthetic.py at commit 79480e8
(``CLASS_NAMES``, ``_unit``, ``make_shape``, ``classification_set``
without its 'hard' variant, ``segmentation_scene``), and from
pointwise_torch/infer.py at the same commit (``big_scene``, the room
sizing of a served scan, and ``scene_features``).
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = (
    "sphere", "cube", "cylinder", "cone", "torus",
    "pyramid", "disk", "helix", "capsule", "cross",
)
NUM_CLASSES = len(CLASS_NAMES)


def _unit(p):
    p = p - p.mean(axis=0, keepdims=True)
    scale = np.linalg.norm(p, axis=1).max()
    return (p / max(scale, 1e-8)).astype(np.float32)


def make_shape(rng: np.random.RandomState, class_id: int, n: int) -> np.ndarray:
    """One surface-sampled primitive, unit-sphere normalized, (n, 3)."""
    u = rng.uniform(0, 1, n)
    v = rng.uniform(0, 1, n)
    name = CLASS_NAMES[class_id % NUM_CLASSES]
    if name == "sphere":
        phi = np.arccos(1 - 2 * u)
        th = 2 * np.pi * v
        p = np.stack([np.sin(phi) * np.cos(th), np.cos(phi), np.sin(phi) * np.sin(th)], 1)
    elif name == "cube":
        face = rng.randint(0, 6, n)
        a = rng.uniform(-1, 1, (n, 2))
        p = np.zeros((n, 3))
        axis, sign = face % 3, (face // 3) * 2 - 1
        others = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
        for ax in range(3):
            sel = axis == ax
            o0, o1 = others[ax]
            p[sel, ax] = sign[sel]
            p[sel, o0] = a[sel, 0]
            p[sel, o1] = a[sel, 1]
    elif name == "cylinder":
        th = 2 * np.pi * u
        p = np.stack([np.cos(th), 2 * v - 1, np.sin(th)], 1)
    elif name == "cone":
        th = 2 * np.pi * u
        rad = 1 - v
        p = np.stack([rad * np.cos(th), 2 * v - 1, rad * np.sin(th)], 1)
    elif name == "torus":
        th, ph = 2 * np.pi * u, 2 * np.pi * v
        rr = 0.35
        p = np.stack(
            [(1 + rr * np.cos(ph)) * np.cos(th), rr * np.sin(ph),
             (1 + rr * np.cos(ph)) * np.sin(th)], 1)
    elif name == "pyramid":
        # 4 triangular faces of a tetrahedron (vectorized barycentric sample)
        verts = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], float)
        faces = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])
        fi = rng.randint(0, 4, n)
        r1, r2 = np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 1, n)
        A, B, C = (verts[faces[fi, j]] for j in range(3))
        p = ((1 - r1)[:, None] * A + (r1 * (1 - r2))[:, None] * B
             + (r1 * r2)[:, None] * C)
    elif name == "disk":
        th = 2 * np.pi * u
        rad = np.sqrt(v)
        p = np.stack([rad * np.cos(th), np.zeros(n), rad * np.sin(th)], 1)
    elif name == "helix":
        t = 4 * np.pi * u
        p = np.stack([np.cos(t), (u - 0.5) * 2, np.sin(t)], 1)
        p += rng.normal(0, 0.05, p.shape)
    elif name == "capsule":
        th = 2 * np.pi * u
        y = 2 * v - 1
        cap = np.abs(y) > 0.5
        rad = np.where(cap, np.sqrt(np.maximum(0, 1 - (2 * np.abs(y) - 1) ** 2)), 1.0)
        p = np.stack([rad * np.cos(th), y * 1.5, rad * np.sin(th)], 1)
    else:  # cross: two orthogonal bars
        which = rng.randint(0, 2, n)
        a = rng.uniform(-1, 1, n)
        b = rng.uniform(-0.2, 0.2, (n, 2))
        p = np.zeros((n, 3))
        p[which == 0] = np.stack([a, b[:, 0], b[:, 1]], 1)[which == 0]
        p[which == 1] = np.stack([b[:, 0], a, b[:, 1]], 1)[which == 1]
    return _unit(p)


def classification_set(seed: int, num_clouds: int, n_points: int = 1024,
                       ):
    """Returns (clouds (num, n, 3) f32, labels (num,) i32)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, NUM_CLASSES, num_clouds).astype(np.int32)
    clouds = np.stack([make_shape(rng, int(c), n_points) for c in labels])
    return clouds.astype(np.float32), labels


def segmentation_scene(seed: int, num_objects: int = 8, points_per_obj: int = 512,
                       room: float = 4.0, num_classes: int = 5):
    """A procedural 'room': primitives scattered on a floor plane.

    Returns xyz (M,3) f32, rgb (M,3) f32 in [0,1], labels (M,) i32 where
    label = class of the owning object (0 = floor).
    """
    rng = np.random.RandomState(seed)
    xyz, rgb, lab = [], [], []
    m_floor = num_objects * points_per_obj // 2
    fx = rng.uniform(0, room, (m_floor, 2))
    xyz.append(np.stack([fx[:, 0], fx[:, 1], np.zeros(m_floor)], 1))
    rgb.append(np.tile([[0.5, 0.5, 0.5]], (m_floor, 1)))
    lab.append(np.zeros(m_floor, np.int32))
    for _ in range(num_objects):
        cls = rng.randint(1, num_classes)
        p = make_shape(rng, cls, points_per_obj) * rng.uniform(0.2, 0.5)
        center = np.array([rng.uniform(0.5, room - 0.5), rng.uniform(0.5, room - 0.5),
                           rng.uniform(0.3, 0.8)])
        xyz.append(p + center)
        color = rng.uniform(0, 1, 3)
        rgb.append(np.tile(color[None], (points_per_obj, 1)))
        lab.append(np.full(points_per_obj, cls, np.int32))
    xyz = np.concatenate(xyz).astype(np.float32)
    rgb = np.concatenate(rgb).astype(np.float32)
    lab = np.concatenate(lab)
    perm = rng.permutation(len(xyz))
    return xyz[perm], rgb[perm], lab[perm]


def big_scene(n_points: int, seed: int = 0, num_classes: int = 5):
    """Procedural scene scaled to ~n_points (room area grows with N to keep
    realistic density)."""
    per_obj = 4096
    num_obj = max(2, int(n_points / (per_obj * 1.5)))
    room = max(4.0, float(np.sqrt(num_obj)) * 1.2)
    return segmentation_scene(
        seed, num_objects=num_obj, points_per_obj=per_obj, room=room,
        num_classes=num_classes,
    )


def scene_features(in_features, xyz, rgb):
    """Training-convention input features: rgb (+ scene-normalized coords)."""
    if in_features == 3:
        return rgb
    mins = xyz.min(0)
    span = np.maximum(xyz.max(0) - mins, 1e-6)
    return np.concatenate([rgb, (xyz - mins) / span], axis=1)
