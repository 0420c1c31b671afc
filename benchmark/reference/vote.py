"""Whole-room labelling by sliding-block overlap voting with the pooled
segmenter, in plain float32 PyTorch.

The net (weights keyed as benchmark/reference/models.py keys them, the
head reading 4 x C skips + 2 x C pooled = 744 features at C = 124): each
block is conv -> LayerNorm (epsilon 1e-6) -> ReLU -> the mask; the head
reads every block's output beside the masked max and mean of the last
block over the chunk's real points, broadcast to every point; each hidden
layer is Linear -> ReLU (dropout off at inference), then ``out`` and the
mask.  Voting: the room cut into 1 m windows at the given stride, every
window's points split into chunks of ``num_points`` that cover them all
(``benchmark/frozen/blocks.room_blocks(..., cover_all=True)`` with
``RandomState(0)``, so the chunks are the program's), each chunk's logits
added into its points' votes.

Departures from the published description (PointNet's S3DIS protocol,
arXiv:1612.00593, with the pointwise convolution of arXiv:1712.05245):
- the global feature is the max and the mean of the last block (PointNet
  takes the max of its last layer), and the head reads every block's
  output (the repository's dense skip);
- LayerNorm where the papers use BatchNorm (the registry's ``norm``);
- a window is split into as many chunks as cover every one of its points,
  the last padded by resampling its own points (PointNet samples 4096);
- the convs compute in float32 where the program rounds their inputs to
  bfloat16 (``rnd`` rounds them to a narrower type for the precision
  control).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.blocks import room_blocks
from benchmark.reference.conv import cloud_conv
from benchmark.reference.models import _block_tail, _blocks, _head


@torch.no_grad()
def pooled_segmenter_logits(w, radii, points, feats, mask, rnd=None):
    """Eval-mode logits (B, N, classes) of a batch of chunks: points
    (B, N, 3) block-centred, feats (B, N, Cin), mask (B, N); zero where
    masked."""
    x, skips = feats, []
    for i in range(_blocks(w)):
        y = cloud_conv(points, x, w[f"blocks.{i}.conv.kernel"],
                       w[f"blocks.{i}.conv.bias"], radii[i], mask, rnd)
        x = _block_tail(w, i, y, mask)
        skips.append(x)
    h = torch.cat(skips, dim=-1)
    m = mask[..., None].to(x.dtype)
    xmax = torch.where(m > 0, x, torch.finfo(x.dtype).min).amax(dim=1)
    xmean = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
    g = torch.cat([xmax, xmean], dim=-1)
    h = torch.cat([h, g[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
    return _head(w, h, 0.0, False) * m


def chunks(xyz, rgb, *, num_points, block_size, stride,
           feature_mode="rgb_norm"):
    """The chunks of a room as the program cuts them (numpy dict of
    ``room_blocks``), or None where no window holds enough points."""
    return room_blocks(
        xyz, rgb, np.zeros(len(xyz), np.int32), num_points=num_points,
        block_size=block_size, stride=stride, rng=np.random.RandomState(0),
        cover_all=True, feature_mode=feature_mode)


@torch.no_grad()
def room_votes(w, radii, xyz, rgb, *, num_classes, num_points, block_size,
               stride, batch_size=16, feature_mode="rgb_norm", rnd=None,
               device="cpu"):
    """Votes (N, classes) f32 on ``device``: each point's logits summed
    over every chunk that holds it (a point a chunk holds twice, as the
    tail's resampling may, counts twice)."""
    dev = torch.device(device)
    votes = torch.zeros((len(xyz), num_classes), dtype=torch.float32,
                        device=dev)
    blocks = chunks(xyz, rgb, num_points=num_points, block_size=block_size,
                    stride=stride, feature_mode=feature_mode)
    if blocks is None:
        return votes
    for s in range(0, len(blocks["points"]), batch_size):
        part = {k: torch.from_numpy(blocks[k][s:s + batch_size]).to(dev)
                for k in ("points", "features", "mask", "index")}
        logits = pooled_segmenter_logits(w, radii, part["points"],
                                         part["features"], part["mask"], rnd)
        votes.index_add_(0, part["index"].reshape(-1).long(),
                         logits.reshape(-1, num_classes))
    return votes
