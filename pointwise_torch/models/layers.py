"""PyTorch layers wrapping the pointwise convolution op.

A port of pointwise_tpu/models/layers.py: a ``PointwiseConv`` module owning
the (27, Cin, Cout) kernel-cell weights, the conv -> norm -> activation
block the networks stack with growing radius, and the masked pool (which
reduces across the space group when the point dim is sharded).  Weights
are laid out as in the JAX package (convert.py carries them over).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from pointwise_torch.ops.pointwise_conv import pointwise_conv
from pointwise_torch.parallel.mesh import all_reduce

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def dense(in_features: int, out_features: int, device=None,
          generator: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` initialised like flax's ``nn.Dense`` (lecun normal,
    zero bias)."""
    lin = nn.Linear(in_features, out_features, device=device)
    with torch.no_grad():
        lecun_normal_(lin.weight, in_features, generator)
        lin.bias.zero_()
    return lin


class PointwiseConv(nn.Module):
    """One pointwise convolution: 27 kernel cells over a radius-r support.

    ``precision='bfloat16'`` (default) runs the kernel with bf16 features,
    means and weights and f32 accumulation; 'float32' for parity work.
    ``impl`` reaches the op unchanged ('spatial:space[:ring]' shards the
    point dim over ``mesh``'s space group).
    """

    def __init__(self, in_features: int, features: int, radius: float, *,
                 use_bias: bool = True, impl: str = "auto",
                 precision: str = "bfloat16", mesh=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.radius = float(radius)
        self.impl = impl
        self.precision = precision
        self.mesh = mesh
        # fan_in = 27 * cin receptive inputs, matching conv-style init.
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(27, in_features, features, device=device),
            27 * in_features, generator))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, points, x, mask=None, centers=None, center_mask=None):
        return pointwise_conv(
            points, x, self.kernel, self.bias, radius=self.radius, mask=mask,
            impl=self.impl, centers=centers, center_mask=center_mask,
            precision=self.precision, mesh=self.mesh)


class SumAcross(torch.autograd.Function):
    """``t`` summed over the members of ``group``: one SUM all-reduce
    forward, and one SUM all-reduce of the cotangents backward (each
    member's input feeds every member's output)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose batch moments ignore masked (padding) rows (a port of
    the JAX ``MaskedBatchNorm``: params scale/bias as ``weight``/``bias``,
    batch_stats mean/var as ``running_mean``/``running_var``).

    Training: f32 moments over every non-feature axis of the rows ``mask``
    keeps, the count clamped to 1 and the biased variance ``s2/cnt - mean^2``
    clamped at 0; the running averages move to ``momentum * old + (1 -
    momentum) * batch``, momentum 0.99.  Evaluation: the running averages.
    Hand-written because ``nn.BatchNorm`` keeps an unbiased running
    variance and the opposite momentum convention.

    ``group``: the process group whose members hold the rest of the batch
    (a mesh's ``world``); the moments' sums are then reduced over it
    (``SumAcross``), so every member normalizes by the global moments."""

    momentum = 0.99

    def __init__(self, features: int, epsilon: float = 1e-5, group=None,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.group = group
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x, mask=None):
        y, moments = self.normalize(x, mask)
        if moments is not None:
            self.update(*moments)
        return y

    def normalize(self, x, mask=None):
        """(normalized x, the batch (mean, var) in training else None): the
        forward without moving the running averages."""
        xf = x.float()
        moments = None
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            m = (torch.ones(x.shape[:-1], device=x.device) if mask is None
                 else mask.float())[..., None]
            red = tuple(range(x.ndim - 1))
            c = x.shape[-1]
            sums = torch.cat([m.sum(red).expand(c), (xf * m).sum(red),
                              (xf * xf * m).sum(red)])
            if self.group is not None:
                sums = SumAcross.apply(sums, self.group)
            cnt, s, s2 = sums.split(c)
            cnt = torch.clamp_min(cnt, 1.0)
            mean = s / cnt
            var = torch.clamp_min(s2 / cnt - mean * mean, 0.0)
            moments = (mean.detach(), var.detach())
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype), moments

    @torch.no_grad()
    def update(self, mean, var):
        """Move the running averages toward a batch's moments."""
        self.running_mean.copy_(self.momentum * self.running_mean
                                + (1.0 - self.momentum) * mean)
        self.running_var.copy_(self.momentum * self.running_var
                               + (1.0 - self.momentum) * var)


class PointwiseConvBlock(nn.Module):
    """conv -> norm -> activation -> out-mask, the trunk unit of all nets.
    Under ``mesh`` a ``norm='batch'`` block reduces its moments over the
    mesh's ``world`` group (``MaskedBatchNorm``): every rank holds part of
    the batch, so the moments are global, as the JAX package's are under
    --dp (a jit over the global batch) and --sp (``bn_axes``).

    ``remat``: while training with gradients on, the block keeps none of
    its activations and the backward recomputes them (``nn.remat`` of the
    JAX nets): the conv kernels (and under a mesh the block's collectives)
    run again inside the backward, in the same order on every rank.  The
    BatchNorm running averages move once per forward, outside the
    recomputed part, as flax drops the recompute's state updates.  The
    conv's cell means, which ``PointwiseConvFunction`` keeps for dW, are
    kept only by the recomputed forward, for this block's backward alone,
    so remat keeps its memory bound and dW still walks nothing."""

    def __init__(self, in_features: int, features: int, radius: float, *,
                 impl: str = "auto", norm: str = "layer",
                 precision: str = "bfloat16", remat: bool = False,
                 mesh=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.remat = remat
        self.conv = PointwiseConv(in_features, features, radius, impl=impl,
                                  precision=precision, mesh=mesh,
                                  device=device, generator=generator)
        if norm == "layer":
            # flax nn.LayerNorm's epsilon (torch's default is 1e-5)
            self.norm = nn.LayerNorm(features, eps=1e-6, device=device)
        elif norm == "batch":
            self.norm = MaskedBatchNorm(
                features, group=None if mesh is None else mesh.group("world"),
                device=device)
        elif norm == "none":
            self.norm = None
        else:
            raise ValueError(f"unknown norm: {norm!r}")

    def forward(self, points, x, mask=None, centers=None, center_mask=None):
        args = (points, x, mask, centers, center_mask)
        if self.remat and self.training and torch.is_grad_enabled():
            # preserve_rng_state=False: a block draws no random numbers
            # (dropout lives in the heads), so there is no state to replay
            y, moments = checkpoint(self._body, *args, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            y, moments = self._body(*args)
        if moments is not None:
            self.norm.update(*moments)
        return y

    def _body(self, points, x, mask, centers, center_mask):
        """(the block's output, BatchNorm's batch moments or None)."""
        y = self.conv(points, x, mask, centers, center_mask)
        out_mask = mask if centers is None else center_mask
        moments = None
        if isinstance(self.norm, MaskedBatchNorm):
            y, moments = self.norm.normalize(y, out_mask)
        elif self.norm is not None:
            y = self.norm(y)
        y = torch.relu(y)
        if out_mask is not None:
            y = y * out_mask.to(y.dtype)[..., None]
        return y, moments


def trunk(in_features: int, channels, radii, **block_kw) -> nn.ModuleList:
    """The nets' stack of conv blocks, block i of width ``channels[i]`` and
    radius ``radii[i]`` (``PointwiseConvBlock_i`` of the JAX tree)."""
    if len(channels) != len(radii):
        raise ValueError("channels and radii must have the same length")
    widths = [in_features, *channels]
    return nn.ModuleList(
        PointwiseConvBlock(widths[i], c, r, **block_kw)
        for i, (c, r) in enumerate(zip(channels, radii)))


class PoolAcross(torch.autograd.Function):
    """The masked pool's partial results of every member of ``group``
    combined: (max, sum, count) -> (max over members, sum, sum).  Forward:
    one MAX all-reduce, then one SUM all-reduce of the sums, the counts and
    which members hold the maximum; backward: one SUM all-reduce of the
    gradients of the max and the sum.  The max's gradient goes to the
    members that hold it, split evenly among ties (as the JAX package's
    all_gather + max differentiates)."""

    @staticmethod
    def forward(ctx, xmax, xsum, cnt, group):
        gmax = all_reduce(xmax, group, dist.ReduceOp.MAX)
        hit = (xmax == gmax).to(xsum.dtype)
        n = xsum.numel()
        tot = all_reduce(torch.cat([xsum.reshape(-1), cnt.reshape(-1),
                                    hit.reshape(-1)]), group)
        gsum = tot[:n].reshape(xsum.shape)
        gcnt = tot[n:n + cnt.numel()].reshape(cnt.shape)
        ties = tot[n + cnt.numel():].reshape(hit.shape)
        ctx.save_for_backward(hit / ties)
        ctx.group = group
        ctx.mark_non_differentiable(gcnt)
        return gmax, gsum, gcnt

    @staticmethod
    def backward(ctx, g_max, g_sum, _g_cnt):
        (share,) = ctx.saved_tensors
        g_max = torch.zeros_like(share) if g_max is None else g_max
        g_sum = torch.zeros_like(share) if g_sum is None else g_sum
        n = g_max.numel()
        tot = all_reduce(torch.cat([g_max.reshape(-1), g_sum.reshape(-1)]),
                         ctx.group)
        return (tot[:n].reshape(share.shape) * share,
                tot[n:].reshape(share.shape), None, None)


def context_group(mesh, axes):
    """The process group a pool reduces over: None for no axes, else
    ``mesh``'s group of the one axis (``context_axes`` of the JAX
    models)."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) != 1 or mesh is None:
        raise ValueError(f"context_axes {axes} needs one mesh axis and "
                         "mesh=")
    return mesh.group(axes[0])


def masked_pool(x: torch.Tensor, mask: torch.Tensor | None, group=None):
    """Concat of masked max-pool and mean-pool over the point dim.

    x: (B, N, C); mask: (B, N) or None. Returns (B, 2C).

    ``group``: the process group the POINT dim is sharded over — the pool
    then combines the members' maxima, sums and counts (``PoolAcross``),
    so the global context is exact under spatial sharding.
    """
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    m = mask.to(x.dtype)[..., None]
    neg = torch.finfo(x.dtype).min
    xmax = torch.amax(torch.where(m > 0, x, neg), dim=1)
    xsum = torch.sum(x * m, dim=1)
    cnt = torch.sum(m, dim=1)
    if group is not None:
        xmax, xsum, cnt = PoolAcross.apply(xmax, xsum, cnt, group)
    return torch.cat([xmax, xsum / torch.clamp_min(cnt, 1.0)], dim=-1)
