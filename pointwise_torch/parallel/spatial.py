"""Spatial (point-dim) parallelism: the point dim sharded over a process group.

A port of pointwise_tpu/parallel/spatial.py.  Each rank holds a slab of the
points of every cloud (B, N_local) and computes the convolution for its
local centers; exactness needs every candidate within ``radius`` of a local
center, which the two strategies bring in:

  * ``gather``: all-gather the candidates over the group, then one conv
    with the local points as centers.  Exact for any point order; feature
    memory O(N_global) per rank.
  * ``ring``: global per-cell counts from an all-gather of the points and
    masks only (``pointwise_conv_counts``), then S partial convolutions
    (``ext_counts=``, which divide by those global counts) while the
    (points, features, mask) slabs rotate round the group, summed in f32.
    Feature memory stays O(N_local): only coordinates reach N_global.

Both are differentiable through explicit ``torch.autograd.Function``s that
run their communication in a fixed order: the gather's backward sums each
rank's slice of the gathered gradient back to its owner (all-reduce, then
the slice: gloo has no reduce-scatter on every build); the ring's backward
walks the reverse ring, each slab travelling back with the gradient its
holders accumulated for it.  Point-to-point calls are never left to the
autograd engine's ordering.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops.pointwise_conv import (
    conv_backward,
    conv_layout,
    pad_counts,
    pointwise_conv,
    pointwise_conv_counts,
)
from pointwise_torch.parallel.mesh import all_gather_cat, all_reduce, ring_shift


class AllGatherPoints(torch.autograd.Function):
    """(B, N_local, C) -> (B, N_global, C), the members' slabs in group-rank
    order; the backward all-reduces the gathered gradient over the group
    and returns this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[1]
        ctx.me = dist.get_rank(group)
        return all_gather_cat(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.float(), ctx.group).to(g.dtype)
        return total[:, ctx.me * ctx.n:(ctx.me + 1) * ctx.n], None


def spatial_pointwise_conv(
    points_local: torch.Tensor,
    features_local: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    radius: float,
    group,
    mask_local: torch.Tensor | None = None,
    strategy: str = "gather",
    precision: str = "float32",
) -> torch.Tensor:
    """Pointwise self-convolution with the point dim sharded over the
    process ``group`` (a mesh's ``group("space")``).

    points_local (B, N_local, 3), features_local (B, N_local, Cin),
    mask_local (B, N_local) or None; every member of the group holds the
    same B clouds.  Returns (B, N_local, Cout) for the local centers, in the
    features' dtype; ``precision`` reaches the kernels unchanged."""
    if points_local.ndim != 3:
        raise ValueError("spatial conv needs batched (B, N_local, 3) points")
    if strategy not in ("gather", "ring"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if group is None:
        raise ValueError("spatial conv needs a process group: "
                         "impl='spatial...' needs mesh= (a "
                         "pointwise_torch.parallel.make_mesh mesh)")
    if strategy == "gather":
        pts_all = all_gather_cat(points_local, group, 1)
        mask_all = (None if mask_local is None
                    else all_gather_cat(mask_local, group, 1))
        return pointwise_conv(
            pts_all, AllGatherPoints.apply(features_local, group), weights,
            bias, radius=radius, mask=mask_all, centers=points_local,
            center_mask=mask_local, precision=precision)
    return _ring_conv(points_local, features_local, weights, bias,
                      radius=radius, group=group, mask_local=mask_local,
                      precision=precision)


def _ring_conv(points_local, features_local, weights, bias, *, radius, group,
               mask_local, precision):
    """The ring: global counts, S partials summed in f32, then the bias once,
    masked (as ``_ring_conv`` of the JAX package adds it)."""
    pts_all = all_gather_cat(points_local, group, 1)
    mask_all = (None if mask_local is None
                else all_gather_cat(mask_local, group, 1))
    counts = pointwise_conv_counts(pts_all, radius=radius, mask=mask_all,
                                   centers=points_local,
                                   center_mask=mask_local)
    y = RingConvFunction.apply(features_local, weights, points_local,
                               mask_local, counts, float(radius), precision,
                               group)
    if bias is not None:
        y = y + bias.to(y.dtype)
        if mask_local is not None:
            y = y * mask_local.to(y.dtype)[..., None]
    return y.to(features_local.dtype)


def _slab_layout(p, f, m, weights, points, mask, counts, radius, precision):
    """Kernel inputs of one partial: candidates (p, f, m) against the local
    centers, dividing by the global counts."""
    kw, (_, nc, cmask) = conv_layout(
        p, f, weights, None, radius=radius, mask=m, centers=points,
        center_mask=mask, precision=precision)
    return kw, nc, cmask, pad_counts(counts, kw["ctr"].shape[1])


class RingConvFunction(torch.autograd.Function):
    """The ring's partial convolutions and their gradient.

    apply(features, weights, points, mask, counts, radius, precision, group)
    -> (B, N_local, Cout) f32: the sum over the group's S slabs of
    ``pointwise_conv(slab, ext_counts=counts, bias=None)`` at the local
    centers, each partial cast to the features' dtype and masked as the op
    returns it, then to f32 before it is added.  Forward: S partials, S-1
    shifts of the slab to the next member.  Backward: the reverse ring
    from the slab held last, each step adding this rank's dX for the slab
    to the gradient that travels with it and shifting both to the previous
    member, so after S-1 shifts every rank holds its own slab with the
    gradient of all S partials; dW sums over the S slabs in f32."""

    @staticmethod
    def forward(ctx, features, weights, points, mask, counts, radius,
                precision, group):
        n = dist.get_world_size(group)
        slab = (points, features, mask)
        y = None
        for step in range(n):
            p, f, m = slab
            kw, nc, cmask, cnt_in = _slab_layout(p, f, m, weights, points,
                                                 mask, counts, radius,
                                                 precision)
            part, _ = tk.conv_fwd(kw["ctr"], kw["pts"], kw["feats"], kw["w"],
                                  kw["bias"], radius, kw["tile_ptr"],
                                  kw["tile_idx"], cnt_in)
            part = part[:, :nc].to(features.dtype)
            if cmask is not None:
                part = part * cmask.to(part.dtype)[..., None]
            part = part.float()
            y = part if y is None else y + part
            if step != n - 1:
                slab = ring_shift(slab, group, 1)
        p, f, m = slab                     # the slab held last, O(N_local)
        ctx.save_for_backward(weights, points, mask, counts, p, f, m)
        ctx.radius, ctx.precision, ctx.group = radius, precision, group
        return y

    @staticmethod
    def backward(ctx, g):
        weights, points, mask, counts, p, f, m = ctx.saved_tensors
        need_f, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        n = dist.get_world_size(ctx.group)
        # the chain of each partial: f32 <- features' dtype <- x mask
        gp = g.to(f.dtype)
        if mask is not None:
            gp = gp * mask.to(gp.dtype)[..., None]
        gp = gp.float()
        d_w = gacc = None
        for step in range(n - 1, -1, -1):
            kw, nc, _, cnt_in = _slab_layout(p, f, m, weights, points, mask,
                                             counts, ctx.radius,
                                             ctx.precision)
            gpad = torch.nn.functional.pad(
                gp, (0, 0, 0, kw["ctr"].shape[1] - nc)).contiguous()
            d_feats, dw = conv_backward(
                gpad, kw["feats"], kw["w"], kw["ctr"], kw["pts"], cnt_in,
                ctx.radius, kw["tile_ptr"], kw["tile_idx"], need_f, need_w)
            if need_w:
                d_w = dw if d_w is None else d_w + dw
            if need_f:
                df = d_feats[:, :f.shape[1]].to(f.dtype)
                gacc = df if gacc is None else gacc + df
            if step != 0:
                p, f, m, gacc = ring_shift((p, f, m, gacc), ctx.group, -1)
        if d_w is not None:
            d_w = d_w.to(weights.dtype)
        return gacc, d_w, None, None, None, None, None, None
