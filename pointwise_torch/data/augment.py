"""Point-cloud transforms on an explicit ``torch.Generator``.

A port of pointwise_tpu/data/augment.py.  Each random transform draws from
the generator it is given, on the clouds' device, so a training step
seeded from (seed, step) replays exactly; a batch draws one value (angle,
ratio, permutation, start point) per cloud, as the JAX ``_batchify`` gives
each cloud its own key.  The numbers differ from ``jax.random``'s for the
same seed; the distributions are the same.  Clouds are (N, 3) or (B, N,
3); the up axis is +Y for objects (``rotate_y``) and +Z for scenes
(``rotate_z``).  ``extras`` of the sampling transforms are per-point arrays
(N, ...) or (B, N, ...) gathered with the points.
"""

from __future__ import annotations

import math

import torch


def _per_cloud(points, draw):
    """One value per cloud: (B,) for batched input, () otherwise."""
    return draw((points.shape[0],) if points.ndim == 3 else ())


def _uniform(points, generator):
    """One U[0, 1) draw per cloud."""
    return _per_cloud(points, lambda shape: torch.rand(
        shape, generator=generator, device=points.device))


def _rotation(points, generator, rows):
    """``points @ rot`` with rot built by ``rows(c, s, one, zero)`` from
    one random angle per cloud."""
    theta = _uniform(points, generator) * (2.0 * math.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack(r, -1) for r in rows(c, s, one, zero)],
                      -2).to(points.dtype)
    return points @ rot


def rotate_y(points, generator: torch.Generator):
    """Random rotation about the up (Y) axis, one angle per cloud."""
    return _rotation(points, generator, lambda c, s, one, zero: (
        (c, zero, s), (zero, one, zero), (-s, zero, c)))


def rotate_z(points, generator: torch.Generator):
    """Random rotation about Z (scene datasets with Z up, e.g. S3DIS), one
    angle per cloud."""
    return _rotation(points, generator, lambda c, s, one, zero: (
        (c, -s, zero), (s, c, zero), (zero, zero, one)))


def normalize_unit_sphere(points, mask=None):
    """Center each cloud on its centroid and scale it into the unit sphere.
    With ``mask`` ((N,) or (B, N)) only the kept points set the centroid
    and the scale, and masked points become the origin."""
    if mask is None:
        p = points - points.mean(dim=-2, keepdim=True)
    else:
        mm = mask.to(points.dtype)[..., None]
        denom = torch.clamp_min(mm.sum(dim=-2, keepdim=True), 1.0)
        p = (points - (points * mm).sum(dim=-2, keepdim=True) / denom) * mm
    scale = torch.clamp_min(
        torch.linalg.vector_norm(p, dim=-1).amax(dim=-1), 1e-8)
    return p / scale[..., None, None]


def jitter(points, generator: torch.Generator, sigma: float = 0.01,
           clip: float = 0.05):
    """Per-point Gaussian jitter, clipped to [-clip, clip]."""
    noise = torch.randn(points.shape, generator=generator,
                        device=points.device, dtype=points.dtype)
    return points + torch.clamp(sigma * noise, -clip, clip)


def random_scale(points, generator: torch.Generator, lo: float = 0.8,
                 hi: float = 1.25):
    """Uniform random scale in [lo, hi), one factor per cloud."""
    s = _per_cloud(points, lambda shape: lo + (hi - lo) * torch.rand(
        shape, generator=generator, device=points.device))
    return points * s.to(points.dtype).reshape(s.shape + (1,) * (points.ndim - 1))


def classification_augment(points, generator: torch.Generator, *,
                           rotate: bool = True):
    """Train-time augmentation of classification clouds: rotation about Y,
    scale, jitter (in that order, as in the JAX package)."""
    if rotate:
        points = rotate_y(points, generator)
    points = random_scale(points, generator)
    return jitter(points, generator)


def random_dropout(points, generator: torch.Generator,
                   max_ratio: float = 0.875):
    """PointNet-style point dropout that keeps the shape: each cloud draws a
    ratio in [0, max_ratio) and every point drawn below it becomes the
    cloud's first point."""
    ratio = _uniform(points, generator) * max_ratio
    drop = torch.rand(points.shape[:-1], generator=generator,
                      device=points.device) < ratio[..., None]
    return torch.where(drop[..., None], points[..., :1, :], points)


def _take(idx, points, extras):
    """points and extras at per-cloud indices ``idx`` ((n,) or (B, n))."""
    def take(a):
        if a.ndim == idx.ndim:          # (B, N) or (N,) per-point values
            return torch.gather(a, -1, idx)
        i = idx.reshape(idx.shape + (1,) * (a.ndim - idx.ndim))
        return torch.gather(a, idx.ndim - 1,
                            i.expand(idx.shape + a.shape[idx.ndim:]))
    out = tuple(take(a) for a in (points, *extras))
    return out if extras else out[0]


def shuffle_points(points, generator: torch.Generator, *extras):
    """A random permutation of each cloud's point order (and of the aligned
    ``extras``)."""
    n = points.shape[-2]
    perm = [torch.randperm(n, generator=generator, device=points.device)
            for _ in range(points.shape[0] if points.ndim == 3 else 1)]
    idx = torch.stack(perm) if points.ndim == 3 else perm[0]
    return _take(idx, points, extras)


def sample_points(points, generator: torch.Generator, n: int, *extras):
    """``n`` points of each cloud drawn uniformly with replacement (and the
    aligned ``extras``)."""
    shape = (points.shape[0], n) if points.ndim == 3 else (n,)
    idx = torch.randint(0, points.shape[-2], shape, generator=generator,
                        device=points.device)
    return _take(idx, points, extras)


def farthest_point_indices(points, n: int, start):
    """Greedy max-min (farthest point) order of ``n`` indices per cloud from
    ``start`` (an int, or (B,) for a batch): each next index is the point
    farthest from those already taken, the first on a tie."""
    batched = points.ndim == 3
    p = points if batched else points[None]
    start = torch.as_tensor(start, device=p.device).reshape(-1).expand(
        p.shape[0]).long()
    rows = torch.arange(p.shape[0], device=p.device)
    idx = torch.empty((p.shape[0], n), dtype=torch.long, device=p.device)
    idx[:, 0] = start
    mind2 = ((p - p[rows, start][:, None]) ** 2).sum(-1)
    for i in range(1, n):
        nxt = mind2.argmax(dim=-1)
        idx[:, i] = nxt
        mind2 = torch.minimum(mind2,
                              ((p - p[rows, nxt][:, None]) ** 2).sum(-1))
    return idx if batched else idx[0]


def farthest_point_sample(points, generator: torch.Generator, n: int,
                          *extras):
    """Farthest-point sampling of each cloud to exactly ``n`` points (and
    the aligned ``extras``), from a uniformly drawn first point.  The JAX
    package's loop is a ``lax.fori_loop`` of the same greedy max-min
    selection, O(n * N)."""
    shape = (points.shape[0],) if points.ndim == 3 else ()
    start = torch.randint(0, points.shape[-2], shape, generator=generator,
                          device=points.device)
    return _take(farthest_point_indices(points, n, start), points, extras)
