"""The segmenter and the classifier in plain float32 PyTorch.

Weights are a dict keyed as benchmark/weights.py makes them:
``blocks.<i>.conv.kernel`` (27, Cin, Cout), ``blocks.<i>.conv.bias``,
``blocks.<i>.norm.weight`` / ``.bias`` (LayerNorm, epsilon 1e-6),
``head.<j>.weight`` (out, in) / ``.bias`` and ``out.weight`` / ``.bias``.
A block is conv -> LayerNorm -> ReLU -> the mask; the segmenter's head
reads every block's output (no global context: the locality-only form),
the classifier's the max and the mean of the last block over the points;
each hidden layer of a head is Linear -> ReLU -> dropout.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference.conv import cloud_conv, scene_conv


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _block_tail(w, i, y, mask):
    c = y.shape[-1]
    y = torch.relu(F.layer_norm(y, (c,), w[f"blocks.{i}.norm.weight"],
                                w[f"blocks.{i}.norm.bias"], eps=1e-6))
    return y if mask is None else y * mask[..., None].to(y.dtype)


def _head(w, h, dropout, train):
    j = 0
    while f"head.{j}.weight" in w:
        h = torch.relu(F.linear(h, w[f"head.{j}.weight"], w[f"head.{j}.bias"]))
        h = F.dropout(h, dropout, training=train)
        j += 1
    return F.linear(h, w["out.weight"], w["out.bias"])


def _blocks(w):
    n = 0
    while f"blocks.{n}.conv.kernel" in w:
        n += 1
    return n


@torch.no_grad()
def segmenter_scene_logits(w, radii, xyz, feats, rnd=None):
    """Eval-mode logits (N, classes) of a whole scene: xyz (N, 3), feats
    (N, Cin), every point a center."""
    x, skips = feats, []
    for i in range(_blocks(w)):
        y = scene_conv(xyz, x, w[f"blocks.{i}.conv.kernel"],
                       w[f"blocks.{i}.conv.bias"], radii[i], rnd)
        x = _block_tail(w, i, y, None)
        skips.append(x)
    return _head(w, torch.cat(skips, dim=-1), 0.0, False)


def segmenter_logits(w, radii, points, feats, mask, dropout, train=True,
                     rnd=None):
    """Logits (B, N, classes) of a batch of blocks, zero where masked."""
    x, skips = feats, []
    for i in range(_blocks(w)):
        y = cloud_conv(points, x, w[f"blocks.{i}.conv.kernel"],
                       w[f"blocks.{i}.conv.bias"], radii[i], mask, rnd)
        x = _block_tail(w, i, y, mask)
        skips.append(x)
    logits = _head(w, torch.cat(skips, dim=-1), dropout, train)
    return logits * mask[..., None].to(logits.dtype)


def classifier_logits(w, radii, points, dropout, train=True, rnd=None):
    """Logits (B, classes) of a batch of clouds (B, N, 3) read as their
    own features."""
    x = points
    for i in range(_blocks(w)):
        y = cloud_conv(points, x, w[f"blocks.{i}.conv.kernel"],
                       w[f"blocks.{i}.conv.bias"], radii[i], None, rnd)
        x = _block_tail(w, i, y, None)
    pooled = torch.cat([x.amax(dim=1), x.mean(dim=1)], dim=-1)
    return _head(w, pooled, dropout, train)


def segmentation_loss(logits, labels, mask):
    """Masked mean negative log-likelihood of the labels."""
    ll = torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                      labels.long()[..., None])[..., 0]
    m = mask.float()
    return -(ll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def classification_loss(logits, labels):
    """Mean negative log-likelihood of the labels."""
    ll = torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                      labels.long()[:, None])[:, 0]
    return -ll.mean()
