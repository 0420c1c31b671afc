"""The training step's random draws, reproduced from its seed.

Copied from pointwise_torch/data/augment.py at commit 79480e8
(``_per_cloud``, ``_uniform``, ``_rotation``, ``rotate_y``, ``jitter``,
``random_scale``, ``classification_augment``) and from
pointwise_torch/train/trainer.py at the same commit (``step_seed``,
``lr_schedule``).  The trainer's step ``s`` of a run with seed ``seed``
draws its augmentation from a device generator seeded with
``step_seed(step_seed(seed, s), 0)`` and its dropout from the default
generators seeded with ``step_seed(step_seed(seed, s), 1)``; the
reference draws the same numbers from the same seeds.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def step_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from ``seed`` and ``keys``."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


def lr_schedule(peak, warmup_steps, decay_steps, min_lr_ratio):
    """Learning rate after ``count`` updates: linear from 1% of the peak to
    the peak over ``warmup_steps``, then cosine down to ``min_lr_ratio`` of
    the peak at ``decay_steps`` (warmup included), constant after."""
    init, end = peak * 0.01, peak * min_lr_ratio
    alpha = 0.0 if peak == 0.0 else end / peak
    warm, decay = warmup_steps, decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warm:
            return (init - peak) * (1.0 - count / warm) + peak
        t = min(count - warm, decay)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay))
                       + alpha)

    return schedule


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
    scale, jitter (in that order)."""
    if rotate:
        points = rotate_y(points, generator)
    points = random_scale(points, generator)
    return jitter(points, generator)
