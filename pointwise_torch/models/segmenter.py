"""Per-point semantic segmentation network (S3DIS / SceneNN style).

A port of ``PointwiseSegmenter`` from pointwise_tpu/models/segmenter.py:
the pointwise-conv trunk with features from every trunk layer concatenated
(dense skip) into a per-point classifier head, plus ``streaming_logits``,
the shrinking-halo forward of the exact streaming engine (streaming.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointwise_torch.models.layers import PointwiseConvBlock, dense, masked_pool


class PointwiseSegmenter(nn.Module):
    """Per-point logits over num_classes for every input point.

    ``in_features`` is the width of ``features`` (3 when the net reads xyz,
    i.e. ``features=None``).  Submodules: ``blocks`` (the trunk), ``head``
    (hidden Linear layers) and ``out``; convert.py maps the JAX parameter
    tree onto them.
    """

    def __init__(self, num_classes: int, in_features: int, *,
                 channels: Sequence[int] = (124, 124, 124, 124),
                 radii: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
                 head_dims: Sequence[int] = (256, 128),
                 dropout_rate: float = 0.3, norm: str = "layer",
                 impl: str = "auto", precision: str = "bfloat16",
                 use_global_context: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(channels) != len(radii):
            raise ValueError("channels and radii must have the same length")
        self.use_global_context = use_global_context
        widths = [in_features, *channels]
        self.blocks = nn.ModuleList(
            PointwiseConvBlock(widths[i], c, r, impl=impl, norm=norm,
                               precision=precision, device=device,
                               generator=generator)
            for i, (c, r) in enumerate(zip(channels, radii)))
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
            g = masked_pool(x, mask)
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


def segmentation_loss(logits, labels, mask=None):
    """Masked per-point softmax cross-entropy and accuracy (the JAX
    package's ``segmentation_loss``).  logits (B, N, K); labels (B, N) int;
    mask (B, N) or None.  Returns (loss, accuracy), f32 scalars."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    correct = (logits.argmax(-1) == labels).float()
    if mask is None:
        return -ll.mean(), correct.mean()
    m = mask.float()
    denom = torch.clamp_min(m.sum(), 1.0)
    return -(ll * m).sum() / denom, (correct * m).sum() / denom
