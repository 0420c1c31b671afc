"""The part segmenter in plain float32 PyTorch.

Weights are keyed as benchmark/reference/models.py keys them, plus
``embed.weight`` (64, categories) and ``embed.bias`` (64,).  Each block is
conv -> LayerNorm (epsilon 1e-6) -> ReLU -> the mask; the head reads every
block's output, the masked max and mean of the last block over the real
points and the category's one-hot through ``embed``, the last two
broadcast to every point; each hidden layer is Linear -> ReLU -> dropout,
then ``out`` and the mask.  The one departure from the program's
``ShapeNetPartSegmenter``: the convs compute in float32 where the program
rounds their inputs to bfloat16 (``rnd`` rounds them to a narrower type).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.conv import cloud_conv
from benchmark.reference.models import _block_tail, _blocks, _head


def partseg_logits(w, radii, points, category, mask, dropout, train=True,
                   rnd=None):
    """Logits (B, N, parts) of a batch of shapes (B, N, 3) read as their
    own features, ``category`` (B,) int ids, zero where masked."""
    x, skips = points, []
    for i in range(_blocks(w)):
        y = cloud_conv(points, x, w[f"blocks.{i}.conv.kernel"],
                       w[f"blocks.{i}.conv.bias"], radii[i], mask, rnd)
        x = _block_tail(w, i, y, mask)
        skips.append(x)
    h = torch.cat(skips, dim=-1)
    m = mask[..., None].to(x.dtype)
    xmax = torch.where(m > 0, x, torch.finfo(x.dtype).min).amax(dim=1)
    xmean = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
    onehot = F.one_hot(category.long(), w["embed.weight"].shape[1])
    emb = F.linear(onehot.to(x.dtype), w["embed.weight"], w["embed.bias"])
    g = torch.cat([xmax, xmean, emb], dim=-1)
    h = torch.cat([h, g[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
    return _head(w, h, dropout, train) * m
