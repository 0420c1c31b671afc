"""Sums-contract loss functions for training over a (data x space) mesh.

A port of pointwise_tpu/parallel/spmd.py.  Under a mesh the trainer
(train/trainer.py) gives each rank its (batch-shard, point-shard) of the
global batch; a model built with ``impl='spatial:space'`` convolves its
local centers against candidates brought in over the space group, and
``context_axes=('space',)`` makes a global pool reduce across it.  Because
a masked mean is not linear across shards, these loss functions return
SUMS: (loss_sum, weight, metric_sums), each the local shard's.  The trainer
sums them and every gradient over the mesh and divides by the summed
weight, so the sharded step equals the unsharded global-mean step.

Per-point jitter is drawn per shard (iid noise, from the trainer's
per-shard generator); per-cloud augmentation (rotations, scales) must not
run here, where a cloud's shards would draw different values: the trainer
applies it to the global batch before sharding (``global_augment``).
"""

from __future__ import annotations

from typing import Callable

from pointwise_torch.data import augment
from pointwise_torch.models import (
    classification_loss_sums,
    segmentation_loss_sums,
)


def seg_spmd_loss_fn(*, jitter_sigma: float = 0.0,
                     jitter_clip: float = 0.02) -> Callable:
    """loss_fn(model, batch, generator, train) -> (nll sum, weight, sums)
    of a segmentation model on its shard of the batch."""

    def loss_fn(model, batch, generator, train):
        pts = batch["points"]
        if train and jitter_sigma > 0:
            pts = augment.jitter(pts, generator, sigma=jitter_sigma,
                                 clip=jitter_clip)
        logits = model(pts, batch["features"], batch["mask"])
        return segmentation_loss_sums(logits, batch["label"], batch["mask"])

    return loss_fn


def partseg_spmd_loss_fn() -> Callable:
    """loss_fn(model, batch, generator, train) -> (nll sum, weight, sums)
    of a ``ShapeNetPartSegmenter`` on its shard of the batch (no
    augmentation: the JAX package trains part segmentation with dropout
    only)."""

    def loss_fn(model, batch, generator, train):
        logits = model(batch["points"], batch["category"],
                       mask=batch["mask"])
        return segmentation_loss_sums(logits, batch["label"], batch["mask"])

    return loss_fn


def cls_spmd_loss_fn() -> Callable:
    """loss_fn(model, batch, generator, train) -> (nll sum, rows, sums) of a
    classifier.  Its only randomness is head dropout after the pool, which
    is identical on every space shard: build the trainer with
    ``rng_axes=('data',)``."""

    def loss_fn(model, batch, generator, train):
        return classification_loss_sums(model(batch["points"]),
                                        batch["label"])

    return loss_fn
