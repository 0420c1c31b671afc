"""Dense PyTorch reference of the pointwise convolution (the executable spec).

A port of pointwise_tpu/ops/reference.py.  For every convolution *center*
``p_i``:
  1. radius neighbor query: all candidates ``p_j`` with ``||p_j - p_i|| <= r``
     (Euclidean ball; the center itself is included, landing in the middle
     cell).
  2. 3x3x3 kernel-cell binning: the cube of side ``2r`` centered at ``p_i`` is
     split into 27 cells; neighbor ``j`` goes to the cell containing
     ``p_j - p_i``.  Per axis: ``c = clip(floor((d + r) * 3 / (2r)), 0, 2)``,
     ``cell = cx*9 + cy*3 + cz``.
  3. cell-wise aggregation: features of the points in each cell are averaged
     (sum / count; empty cells contribute zero).
  4. kernel matmul: ``y_i = sum_k W_k @ xbar_k + b``.

O(N*M) dense and differentiable by autograd; the ground truth the kernel
path (ops/pointwise_conv.py) is held against.  Centers are taken in chunks
so that the (centers, candidates, 27) one-hot stays bounded in memory.
"""

from __future__ import annotations

import torch

N_CELLS = 27
_CHUNK_ELEMS = 1 << 24      # one-hot elements per center chunk


def cell_index(rel: torch.Tensor, radius: float) -> torch.Tensor:
    """3x3x3 cell id for relative coordinates ``rel`` (..., 3) in [-r, r]^3.

    Points exactly on the +r boundary are clamped into the outermost cell.
    """
    c = torch.clamp(torch.floor((rel + radius) * (3.0 / (2.0 * radius))),
                    0.0, 2.0).to(torch.int64)
    return c[..., 0] * 9 + c[..., 1] * 3 + c[..., 2]


def _conv(centers, points, features, weights, bias, radius, mask,
          center_mask, ext_counts=None):
    """Batched conv. centers (B,Nc,3), points (B,M,3), features (B,M,Cin).

    ext_counts: optional (B, Nc, 27) EXTERNAL divisor counts — the
    partial-conv contract: with global counts fixed, outputs over disjoint
    candidate subsets sum to the full conv.
    """
    rel = points[:, None, :, :] - centers[:, :, None, :]   # (B, Nc, M, 3)
    d2 = torch.sum(rel * rel, dim=-1)                      # (B, Nc, M)
    valid = d2 <= torch.tensor(radius, dtype=d2.dtype) ** 2
    if mask is not None:
        valid = valid & mask.bool()[:, None, :]
    cell = cell_index(rel, radius)                         # (B, Nc, M)
    onehot = torch.nn.functional.one_hot(cell, N_CELLS).to(features.dtype)
    onehot = onehot * valid.to(features.dtype)[..., None]  # (B, Nc, M, 27)
    sums = torch.einsum("bimk,bmc->bikc", onehot, features)
    cnt = onehot.sum(dim=2) if ext_counts is None else ext_counts
    xbar = sums / torch.clamp_min(cnt, 1.0)[..., None]
    y = torch.einsum("bikc,kcd->bid", xbar, weights)
    if bias is not None:
        y = y + bias
    if center_mask is not None:
        y = y * center_mask.to(y.dtype)[..., None]
    return y


def pointwise_conv_reference(
    points: torch.Tensor,
    features: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    radius: float,
    mask: torch.Tensor | None = None,
    centers: torch.Tensor | None = None,
    center_mask: torch.Tensor | None = None,
    ext_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense reference pointwise convolution.

    Args:
      points: (M, 3) or (B, M, 3) candidate point positions.
      features: (M, Cin) or (B, M, Cin) features of the candidate points.
      weights: (27, Cin, Cout) kernel-cell weights.
      bias: optional (Cout,).
      radius: kernel support radius.
      mask: optional (M,) / (B, M) validity of candidates (0 = padding).
      centers: optional (Nc, 3) / (B, Nc, 3) convolution centers; defaults to
        ``points`` (every point is a center).
      center_mask: optional validity of centers; masked centers output 0.
        Defaults to ``mask`` only when ``centers`` is not given.
      ext_counts: optional (Nc, 27) / (B, Nc, 27) external divisor counts.

    Returns:
      (Nc, Cout) or (B, Nc, Cout) output features.
    """
    batched = points.ndim == 3
    if not batched:
        points, features = points[None], features[None]
        mask = None if mask is None else mask[None]
        centers = None if centers is None else centers[None]
        center_mask = None if center_mask is None else center_mask[None]
        ext_counts = None if ext_counts is None else ext_counts[None]
    if centers is None:
        centers = points
        if center_mask is None:
            center_mask = mask
    B, Nc, M = points.shape[0], centers.shape[1], points.shape[1]
    step = max(1, _CHUNK_ELEMS // max(1, B * M * N_CELLS))
    ys = [_conv(centers[:, s:s + step], points, features, weights, bias,
                radius, mask,
                None if center_mask is None else center_mask[:, s:s + step],
                None if ext_counts is None else ext_counts[:, s:s + step])
          for s in range(0, Nc, step)]
    y = torch.cat(ys, dim=1)
    return y if batched else y[0]
