"""Per-point segmentation networks (S3DIS / SceneNN / ShapeNetPart).

A port of pointwise_tpu/models/segmenter.py: ``PointwiseSegmenter``, the
pointwise-conv trunk with features from every trunk layer concatenated
(dense skip) into a per-point classifier head, plus ``streaming_logits``,
the shrinking-halo forward of the exact streaming engine (streaming.py);
``ShapeNetPartSegmenter``, the deeper part segmenter conditioned on the
object category; and the masked segmentation losses.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointwise_torch.models.layers import (context_group, dense, masked_pool,
                                           trunk)
from pointwise_torch.utils.runtime import span


class PointwiseSegmenter(nn.Module):
    """Per-point logits over num_classes for every input point.

    ``in_features`` is the width of ``features`` (3 when the net reads xyz,
    i.e. ``features=None``).  Submodules: ``blocks`` (the trunk), ``head``
    (hidden Linear layers) and ``out``; convert.py maps the JAX parameter
    tree onto them.

    Spatial sharding: ``impl='spatial:space[:ring]'`` convolves over
    ``mesh``'s space group, and ``context_axes=('space',)`` makes the
    global-context pool reduce across it (the JAX model's field of the same
    name); under ``mesh`` the ``norm='batch'`` moments are global over it
    (``PointwiseConvBlock``).

    ``remat=True`` recomputes each trunk block's activations in the
    backward instead of keeping them (``PointwiseConvBlock``); the outputs,
    gradients and ``state_dict`` keys are those of ``remat=False``.

    With the global context the pool and its broadcast beside the skips
    are the span ``seg.context`` (``runtime.span``, a range only under a
    profiler); the locality-only forward opens none.
    """

    def __init__(self, num_classes: int, in_features: int, *,
                 channels: Sequence[int] = (124, 124, 124, 124),
                 radii: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
                 head_dims: Sequence[int] = (256, 128),
                 dropout_rate: float = 0.3, norm: str = "layer",
                 impl: str = "auto", precision: str = "bfloat16",
                 remat: bool = False, use_global_context: bool = True,
                 context_axes: Sequence[str] = (),
                 mesh=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_global_context = use_global_context
        self.context = context_group(mesh, context_axes)
        self.blocks = trunk(in_features, channels, radii, impl=impl,
                            norm=norm, precision=precision, remat=remat,
                            mesh=mesh, device=device, generator=generator)
        h = sum(channels) + (2 * channels[-1] if use_global_context else 0)
        dims = [h, *head_dims]
        self.head = nn.ModuleList(
            dense(dims[i], d, device, generator)
            for i, d in enumerate(head_dims))
        self.drop = nn.Dropout(dropout_rate)
        self.out = dense(dims[-1], num_classes, device, generator)

    def forward(self, points, features=None, mask=None):
        """points (B,N,3); features (B,N,C) or None -> xyz; out (B,N,classes)."""
        x = points if features is None else features
        skips = []
        for blk in self.blocks:
            x = blk(points, x, mask)
            skips.append(x)
        h = torch.cat(skips, dim=-1)
        if self.use_global_context:
            with span("seg.context"):
                g = masked_pool(x, mask, self.context)
                h = torch.cat([h, g[:, None, :].expand(-1, h.shape[1], -1)],
                              dim=-1)
        return self._head(h, mask)

    def _head(self, h, mask):
        for lin in self.head:
            h = self.drop(torch.relu(lin(h)))
        logits = self.out(h)
        if mask is not None:
            logits = logits * mask.to(logits.dtype)[..., None]
        return logits

    def streaming_logits(self, points, features, counts, sels, skips, *,
                         lengths):
        """Shrinking-halo forward for exact streaming (overlap-save) eval.

        Layer ``l`` computes outputs only where later layers still need them;
        each layer's centers are an index gather of the previous layer's
        candidates (see streaming.stream_apply_layered).

        Args:
          points/features: (B, p_0, ...) morton-ordered, padded tile arrays.
          counts: (B, L+1) int — true set sizes n_0 >= ... >= n_L per tile;
            slots beyond ``counts[:, l]`` are masked out of layer ``l``.
          sels: L int tensors; sels[l] (B, p_{l+1}) = positions, within layer
            l's candidate array, of layer l's centers.
          skips: L int tensors; skips[l] (B, p_L) = positions, within layer
            l's OUTPUT array, of the tile interior.
          lengths: non-increasing tuple (p_0, ..., p_L).

        Returns (B, p_L, num_classes) logits; slots ``>= counts[:, L]`` are
        zero.  Exact iff halo_l >= sum(radii[l:]) and
        use_global_context=False.
        """
        if self.use_global_context:
            raise ValueError(
                "streaming_logits requires use_global_context=False "
                "(the global pool is not a local computation)")
        if len(lengths) != len(self.blocks) + 1:
            raise ValueError(
                f"lengths must have {len(self.blocks) + 1} entries, "
                f"got {len(lengths)}")
        iota = torch.arange(lengths[0], device=points.device)

        def prefix_mask(level, p):
            return (iota[:p][None, :] < counts[:, level:level + 1]).float()

        def gather(arr, idx):
            idx = idx.long()[..., None].expand(-1, -1, arr.shape[-1])
            return torch.gather(arr, 1, idx)

        x = points if features is None else features
        pts_cur = points
        skip_feats = []
        for l, blk in enumerate(self.blocks):
            ctr = gather(pts_cur, sels[l])              # (B, p_{l+1}, 3)
            x = blk(pts_cur, x, prefix_mask(l, lengths[l]), ctr,
                    prefix_mask(l + 1, lengths[l + 1]))
            skip_feats.append(gather(x, skips[l]))      # (B, p_L, C_l)
            pts_cur = ctr
        h = torch.cat(skip_feats, dim=-1)
        return self._head(h, prefix_mask(len(self.blocks), lengths[-1]))


class ShapeNetPartSegmenter(nn.Module):
    """Part segmentation conditioned on the object category (a port of the
    JAX ``ShapeNetPartSegmenter``): a deeper trunk, and a head that reads
    every block's features, the masked max and mean pool of the last block
    and the category's one-hot through ``embed`` (64 wide), broadcast to
    every point.

    Submodules: ``blocks``, ``embed`` (the JAX tree's ``Dense_0``: flax
    names the category embedding first), ``head`` (``Dense_1`` ..) and
    ``out`` (the last ``Dense_*``); convert.py maps them.  ``context_axes``,
    ``mesh`` and ``remat`` as in ``PointwiseSegmenter``.

    The forward's spans (``runtime.span``, ranges only under a profiler):
    ``partseg.context`` (the pool, the embedding and their broadcast beside
    the skips) and ``partseg.head`` (the head and ``out``)."""

    def __init__(self, num_parts: int = 50, num_categories: int = 16,
                 in_features: int = 3, *,
                 channels: Sequence[int] = (124, 124, 124, 124, 124, 124),
                 radii: Sequence[float] = (0.15, 0.25, 0.4, 0.6, 0.9, 1.4),
                 head_dims: Sequence[int] = (256, 128),
                 dropout_rate: float = 0.3, norm: str = "layer",
                 impl: str = "auto", precision: str = "bfloat16",
                 remat: bool = False, context_axes: Sequence[str] = (),
                 mesh=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_categories = num_categories
        self.context = context_group(mesh, context_axes)
        self.blocks = trunk(in_features, channels, radii, impl=impl,
                            norm=norm, precision=precision, remat=remat,
                            mesh=mesh, device=device, generator=generator)
        self.embed = dense(num_categories, 64, device, generator)
        dims = [sum(channels) + 2 * channels[-1] + 64, *head_dims]
        self.head = nn.ModuleList(
            dense(dims[i], d, device, generator)
            for i, d in enumerate(head_dims))
        self.drop = nn.Dropout(dropout_rate)
        self.out = dense(dims[-1], num_parts, device, generator)

    def forward(self, points, category, features=None, mask=None):
        """points (B,N,3); category (B,) int ids; features (B,N,C) or None
        -> xyz.  Returns (B, N, num_parts) logits, zero where masked."""
        x = points if features is None else features
        skips = []
        for blk in self.blocks:
            x = blk(points, x, mask)
            skips.append(x)
        h = torch.cat(skips, dim=-1)
        with span("partseg.context"):
            onehot = nn.functional.one_hot(category.long(),
                                           self.num_categories).to(h.dtype)
            g = torch.cat([masked_pool(x, mask, self.context),
                           self.embed(onehot)], dim=-1)
            h = torch.cat([h, g[:, None, :].expand(-1, h.shape[1], -1)],
                          dim=-1)
        with span("partseg.head"):
            for lin in self.head:
                h = self.drop(torch.relu(lin(h)))
            logits = self.out(h)
            if mask is not None:
                logits = logits * mask.to(logits.dtype)[..., None]
        return logits


def _log_likelihood(logits, labels, class_weights):
    """Per-point log-probability of the label, times its class weight."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if class_weights is not None:
        ll = ll * class_weights[labels.long()]
    return ll


def segmentation_loss_sums(logits, labels, mask=None, class_weights=None):
    """Shard-local sums of ``segmentation_loss`` (the trainer's sums
    contract under a mesh): (nll sum, weight, {"accuracy": correct sum}).
    Summed over the mesh and divided by the summed weight they give the
    global masked means exactly (a masked mean is not linear across shards,
    sums are)."""
    ll = _log_likelihood(logits, labels, class_weights)
    correct = (logits.argmax(-1) == labels).float()
    m = torch.ones_like(ll) if mask is None else mask.float()
    return -(ll * m).sum(), m.sum(), {"accuracy": (correct * m).sum()}


def segmentation_loss(logits, labels, mask=None, class_weights=None):
    """Masked per-point softmax cross-entropy and accuracy (the JAX
    package's ``segmentation_loss``).  logits (B, N, K); labels (B, N) int;
    mask (B, N) or None; ``class_weights`` (K,) scales each point's
    log-likelihood by its label's weight.  Returns (loss, accuracy), f32
    scalars."""
    ll = _log_likelihood(logits, labels, class_weights)
    correct = (logits.argmax(-1) == labels).float()
    if mask is None:
        return -ll.mean(), correct.mean()
    m = mask.float()
    denom = torch.clamp_min(m.sum(), 1.0)
    return -(ll * m).sum() / denom, (correct * m).sum() / denom
