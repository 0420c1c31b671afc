"""Point-cloud augmentations on an explicit ``torch.Generator``.

A port of the training transforms of pointwise_tpu/data/augment.py
(``jitter``, ``rotate_y``, ``random_scale``, ``classification_augment``).
Each draws from the generator it is given, on the clouds' device, so a
training step seeded from (seed, step) replays exactly.  The numbers differ
from ``jax.random``'s for the same seed; the distributions are the same.
Clouds are (N, 3) or (B, N, 3); the up axis is +Y (rotation about Y).
"""

from __future__ import annotations

import math

import torch


def _per_cloud(points, draw):
    """One value per cloud: (B,) for batched input, () otherwise."""
    return draw((points.shape[0],) if points.ndim == 3 else ())


def rotate_y(points, generator: torch.Generator):
    """Random rotation about the up (Y) axis, one angle per cloud."""
    theta = _per_cloud(points, lambda shape: torch.rand(
        shape, generator=generator, device=points.device) * (2.0 * math.pi))
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([c, zero, s], -1),
                       torch.stack([zero, one, zero], -1),
                       torch.stack([-s, zero, c], -1)], -2).to(points.dtype)
    return points @ rot


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
