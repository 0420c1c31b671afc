"""Useful work, counted from the inputs whatever implements them.

In-ball pairs are counted here with plain PyTorch on the device (never
with the program's counts kernel).  Each conv call's work is the formula
of chip_smoke.py's ``bound()`` at commit 79480e8: ``pairs x width`` adds
(width Cin for the forward and dW, Cout for dX) plus the product's
``2 x 27 x Cin x Cout`` operations per real row, both at the bf16
tensor-core peak; its bytes are each input read once and each output
written once (points f32, features, weights and the gradient of y in
bf16, outputs f32).  A call's least time is the larger of its operations
over the peak and its bytes over HBM bandwidth.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989.4 TFLOP/s, HBM3 3.35
TB/s, at the card's full 700 W.
"""

from __future__ import annotations

import torch

from benchmark.neighbors import voxel_groups

PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12
N_CELLS = 27


@torch.no_grad()
def scene_pairs(xyz: torch.Tensor, radius: float) -> int:
    """In-ball (center, candidate) pairs of a scene (N, 3) with every
    point a center, the center itself included."""
    total = 0
    for centers, cand in voxel_groups(xyz, radius):
        d = xyz[cand][None, :, :] - xyz[centers][:, None, :]
        total += int((torch.sum(d * d, dim=-1) <= radius * radius).sum())
    return total


@torch.no_grad()
def cloud_pairs(points: torch.Tensor, radii, mask=None) -> list:
    """In-ball pairs of a batch of clouds (B, N, 3) at each radius of
    ``radii``, each point of a cloud a center over the cloud's points;
    masked points take no part."""
    B, N, _ = points.shape
    chunk = max(1, (1 << 27) // (N * N))
    totals = [0] * len(radii)
    for s in range(0, B, chunk):
        p = points[s:s + chunk]
        d = p[:, None, :, :] - p[:, :, None, :]
        d2 = torch.sum(d * d, dim=-1)
        del d
        if mask is not None:
            v = mask[s:s + chunk] > 0
            d2 = torch.where(v[:, None, :] & v[:, :, None], d2, torch.inf)
        for i, r in enumerate(radii):
            totals[i] += int((d2 <= r * r).sum())
    return totals


def conv_call(kind: str, pairs: int, rows: int, cin: int, cout: int):
    """(operations, bytes) of one conv call over ``rows`` real centers
    (self-convolution: as many candidates): ``kind`` fwd, dw or dx."""
    width = cout if kind == "dx" else cin
    ops = pairs * width + 2.0 * N_CELLS * cin * cout * rows
    pts = rows * 12
    if kind == "fwd":
        nbytes = pts + rows * cin * 2 + N_CELLS * cin * cout * 2 + rows * cout * 4
    elif kind == "dw":
        nbytes = pts + rows * cin * 2 + rows * cout * 2 + N_CELLS * cin * cout * 4
    else:
        nbytes = pts + rows * cout * 2 + N_CELLS * cin * cout * 2 + rows * cin * 4
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def forward_work(pairs: list, rows: int, widths: list):
    """(operations, conv least seconds) of one forward of the trunk over
    ``rows`` points, ``pairs[l]`` in-ball pairs at layer l, widths
    [Cin, C1, ..]."""
    ops = least = 0.0
    for l, p in enumerate(pairs):
        o, b = conv_call("fwd", p, rows, widths[l], widths[l + 1])
        ops += o
        least += least_seconds(o, b)
    return ops, least


def train_step_work(pairs: list, rows: int, widths: list):
    """(operations, conv least seconds) of the trunk's forward, dW and dX
    of one training step (no dX for the first block, whose input needs no
    gradient)."""
    ops = least = 0.0
    for l, p in enumerate(pairs):
        for kind in ("fwd", "dw", "dx") if l else ("fwd", "dw"):
            o, b = conv_call(kind, p, rows, widths[l], widths[l + 1])
            ops += o
            least += least_seconds(o, b)
    return ops, least


def head_ops(rows: int, dims: list, passes: int) -> float:
    """Operations of a head of Linear layers ``dims`` over ``rows`` rows:
    ``passes`` 1 for a forward, 3 for forward, dW and dX."""
    return passes * sum(2.0 * rows * a * b for a, b in zip(dims, dims[1:]))
