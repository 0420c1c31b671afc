"""PyTorch layers wrapping the pointwise convolution op.

A port of pointwise_tpu/models/layers.py: a ``PointwiseConv`` module owning
the (27, Cin, Cout) kernel-cell weights, the conv -> norm -> activation
block the networks stack with growing radius, and the masked pool.  Weights
are laid out as in the JAX package (convert.py carries them over).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pointwise_torch.ops.pointwise_conv import pointwise_conv

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
    """

    def __init__(self, in_features: int, features: int, radius: float, *,
                 use_bias: bool = True, impl: str = "auto",
                 precision: str = "bfloat16", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.radius = float(radius)
        self.impl = impl
        self.precision = precision
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
            precision=self.precision)


class MaskedBatchNorm(nn.Module):
    """BatchNorm in running-average mode, for checkpoints trained with
    ``--norm batch`` (the JAX MaskedBatchNorm: params scale/bias, batch_stats
    mean/var, epsilon 1e-5).  Batch statistics (training) arrive with the
    training slice."""

    def __init__(self, features: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x, mask=None):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm batch statistics: not yet ported (call "
                ".eval() to use the running averages)")
        y = (x.float() - self.running_mean) * torch.rsqrt(
            self.running_var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)


class PointwiseConvBlock(nn.Module):
    """conv -> norm -> activation -> out-mask, the trunk unit of all nets."""

    def __init__(self, in_features: int, features: int, radius: float, *,
                 impl: str = "auto", norm: str = "layer",
                 precision: str = "bfloat16", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = PointwiseConv(in_features, features, radius, impl=impl,
                                  precision=precision, device=device,
                                  generator=generator)
        if norm == "layer":
            # flax nn.LayerNorm's epsilon (torch's default is 1e-5)
            self.norm = nn.LayerNorm(features, eps=1e-6, device=device)
        elif norm == "batch":
            self.norm = MaskedBatchNorm(features, device=device)
        elif norm == "none":
            self.norm = None
        else:
            raise ValueError(f"unknown norm: {norm!r}")

    def forward(self, points, x, mask=None, centers=None, center_mask=None):
        y = self.conv(points, x, mask, centers, center_mask)
        out_mask = mask if centers is None else center_mask
        if isinstance(self.norm, MaskedBatchNorm):
            y = self.norm(y, out_mask)
        elif self.norm is not None:
            y = self.norm(y)
        y = torch.relu(y)
        if out_mask is not None:
            y = y * out_mask.to(y.dtype)[..., None]
        return y


def masked_pool(x: torch.Tensor, mask: torch.Tensor | None):
    """Concat of masked max-pool and mean-pool over the point dim.

    x: (B, N, C); mask: (B, N) or None. Returns (B, 2C).
    """
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    m = mask.to(x.dtype)[..., None]
    neg = torch.finfo(x.dtype).min
    xmax = torch.amax(torch.where(m > 0, x, neg), dim=1)
    xsum = torch.sum(x * m, dim=1)
    cnt = torch.sum(m, dim=1)
    return torch.cat([xmax, xsum / torch.clamp_min(cnt, 1.0)], dim=-1)
