"""Point-cloud classification network (ModelNet40 workload).

A port of ``PointwiseClassifier`` of pointwise_tpu/models/classifier.py:
four stacked pointwise convolutions over the constant point set with
growing radius, masked max+mean pooling, then a fully-connected head to
the class logits.  Submodules ``blocks``, ``head`` and ``out`` carry the
JAX parameter tree's layout (convert.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointwise_torch.models.layers import (context_group, dense, masked_pool,
                                           trunk)


class PointwiseClassifier(nn.Module):
    """(B, N, 3) points (+ optional (B, N, C) features) -> (B, classes).

    ``in_features`` is the width of ``features`` (3 when the net reads
    xyz, i.e. ``features=None``).  Built with ``impl='spatial:space'``,
    ``context_axes=('space',)`` and ``mesh=`` it runs on points sharded
    over the mesh's space group; the pooled head is then identical on every member
    (its dropout must not fold in the space index: the trainer's
    ``rng_axes=('data',)``).  ``mesh``, ``norm='batch'`` and ``remat``
    as in ``PointwiseSegmenter``."""

    def __init__(self, num_classes: int = 40, in_features: int = 3, *,
                 channels: Sequence[int] = (124, 124, 124, 124),
                 radii: Sequence[float] = (0.25, 0.5, 1.0, 2.0),
                 head_dims: Sequence[int] = (256, 128),
                 dropout_rate: float = 0.3, norm: str = "layer",
                 impl: str = "auto", precision: str = "bfloat16",
                 remat: bool = False, context_axes: Sequence[str] = (),
                 mesh=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.context = context_group(mesh, context_axes)
        self.blocks = trunk(in_features, channels, radii, impl=impl,
                            norm=norm, precision=precision, remat=remat,
                            mesh=mesh, device=device, generator=generator)
        dims = [2 * channels[-1], *head_dims]
        self.head = nn.ModuleList(
            dense(dims[i], d, device, generator)
            for i, d in enumerate(head_dims))
        self.drop = nn.Dropout(dropout_rate)
        self.out = dense(dims[-1], num_classes, device, generator)

    def forward(self, points, features=None, mask=None):
        x = points if features is None else features
        for blk in self.blocks:
            x = blk(points, x, mask)
        h = masked_pool(x, mask, self.context)         # (B, 2C)
        for lin in self.head:
            h = self.drop(torch.relu(lin(h)))
        return self.out(h)


def classification_loss_sums(logits, labels):
    """Shard-local sums of ``classification_loss`` (the trainer's sums
    contract): (nll sum, rows, {"accuracy": correct sum})."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    correct = (logits.argmax(-1) == labels).float()
    w = torch.tensor(float(labels.shape[0]), device=logits.device)
    return -ll.sum(), w, {"accuracy": correct.sum()}


def classification_loss(logits, labels):
    """Softmax cross-entropy and accuracy over (B, K) logits and (B,) int
    labels (the JAX package's ``classification_loss``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    return -ll.mean(), acc
