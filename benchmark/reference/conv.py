"""The pointwise convolution in plain float32 PyTorch.

The semantics are those of pointwise_torch/ops/reference.py at commit
79480e8 (``cell_index`` is copied from it): for every center p_i, the
candidates p_j with ||p_j - p_i|| <= r are binned into the 27 cells of the
cube of side 2r around p_i, each cell's features are averaged (sum /
count; empty cells give zero), and y_i = sum_k W_k . xbar_k + b.  Here the
cell sums are 27 masked products per block of centers, so that a scene of
a million points fits: a whole scene through ``neighbors.voxel_groups``,
a training cloud as one block with its own backward (the masks are
recomputed there instead of kept).

``rnd``: None for float32, or a function applied where the program rounds
to its matmul type (features, weights, means, the gradient of y and the
scaled cell gradients); the precision control passes one that rounds to a
narrower type.
"""

from __future__ import annotations

import torch

from benchmark.neighbors import voxel_groups

N_CELLS = 27


def cell_index(rel: torch.Tensor, radius: float) -> torch.Tensor:
    """3x3x3 cell id for relative coordinates ``rel`` (..., 3) in [-r, r]^3.

    Points exactly on the +r boundary are clamped into the outermost cell.
    """
    c = torch.clamp(torch.floor((rel + radius) * (3.0 / (2.0 * radius))),
                    0.0, 2.0).to(torch.int64)
    return c[..., 0] * 9 + c[..., 1] * 3 + c[..., 2]


def _same(t):
    return t


def _cells(ctr, pts, radius, pvalid=None):
    """(n_c, n_m) uint8 cell of each (center, candidate) pair, 27 where the
    candidate is out of the ball or masked."""
    rel = pts[None, :, :] - ctr[:, None, :]
    inside = torch.sum(rel * rel, dim=-1) <= radius * radius
    if pvalid is not None:
        inside &= pvalid[None, :]
    return torch.where(inside, cell_index(rel, radius),
                       N_CELLS).to(torch.uint8)


def cell_means(ctr, pts, feats, radius, pvalid=None):
    """(xbar (n_c, 27, Cin), counts (n_c, 27)) of centers ``ctr`` over
    candidates ``pts`` with features ``feats``."""
    cells = _cells(ctr, pts, radius, pvalid)
    sums, cnt = [], []
    for k in range(N_CELLS):
        m = (cells == k).to(feats.dtype)
        sums.append(m @ feats)
        cnt.append(m.sum(dim=1))
    cnt = torch.stack(cnt, dim=1)
    xbar = torch.stack(sums, dim=1) / torch.clamp_min(cnt, 1.0)[..., None]
    return xbar, cnt


def _spread(ctr, pts, dxbar, radius, pvalid=None):
    """sum_k M_k^T . dxbar[:, k]: each center's per-cell gradient handed to
    the candidates of that cell (n_m, Cin)."""
    cells = _cells(ctr, pts, radius, pvalid)
    out = torch.zeros((pts.shape[0], dxbar.shape[-1]), dtype=dxbar.dtype,
                      device=dxbar.device)
    for k in range(N_CELLS):
        out += (cells == k).to(dxbar.dtype).T @ dxbar[:, k]
    return out


class CloudConv(torch.autograd.Function):
    """One cloud's self-convolution with its gradient in features, weights
    and bias (points carry none)."""

    @staticmethod
    def forward(ctx, feats, weights, bias, pts, valid, radius, rnd):
        f = rnd(feats)
        w = rnd(weights)
        xbar, cnt = cell_means(pts, pts, f, radius, valid)
        xbar = rnd(xbar)
        y = xbar.reshape(len(pts), -1) @ w.reshape(-1, w.shape[-1]) + bias
        ctx.save_for_backward(xbar, cnt, w, pts, valid)
        ctx.radius, ctx.rnd = radius, rnd
        return y

    @staticmethod
    def backward(ctx, g):
        xbar, cnt, w, pts, valid = ctx.saved_tensors
        rnd = ctx.rnd
        g = rnd(g)
        n, cin, cout = xbar.shape[0], w.shape[1], w.shape[2]
        d_w = (xbar.reshape(n, -1).T @ g).reshape(N_CELLS, cin, cout)
        d_bias = g.sum(dim=0)
        d_feats = None
        if ctx.needs_input_grad[0]:
            z = (g @ w.reshape(-1, cout).T).reshape(n, N_CELLS, cin)
            z = rnd(z / torch.clamp_min(cnt, 1.0)[..., None])
            d_feats = _spread(pts, pts, z, ctx.radius, valid)
        return d_feats, d_w, d_bias, None, None, None, None


def cloud_conv(points, feats, weights, bias, radius, mask=None, rnd=None):
    """Self-convolution of a batch of clouds (B, N, 3) -> (B, N, Cout),
    differentiable; masked candidates take no part and masked centers
    give zeros."""
    rnd = rnd or _same
    out = []
    for b in range(points.shape[0]):
        valid = None if mask is None else mask[b] > 0
        y = CloudConv.apply(feats[b], weights, bias, points[b],
                            valid, float(radius), rnd)
        if valid is not None:
            y = y * valid[:, None].to(y.dtype)
        out.append(y)
    return torch.stack(out)


@torch.no_grad()
def scene_conv(xyz, feats, weights, bias, radius, rnd=None):
    """Self-convolution of one whole scene (N, 3) -> (N, Cout), every
    point a center, through voxel groups."""
    rnd = rnd or _same
    f = rnd(feats)
    w = rnd(weights).reshape(-1, weights.shape[-1])
    y = torch.empty((len(xyz), weights.shape[-1]), dtype=torch.float32,
                    device=xyz.device)
    for centers, cand in voxel_groups(xyz, radius):
        xbar, _ = cell_means(xyz[centers], xyz[cand], f[cand], radius)
        y[centers] = rnd(xbar).reshape(len(centers), -1) @ w + bias
    return y
