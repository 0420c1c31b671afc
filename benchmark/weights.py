"""Weights made from the seed on the device, in one draw.

The harness makes them and hands the same tensors to the program (through
``load_state_dict``) and to the reference.  Keys follow the nets'
parameter names; conv kernels and Linear weights are scaled by the square
root of their fan-in, biases and LayerNorm parameters are small draws
around 0 and 1, so that every tensor matters to the result.
"""

from __future__ import annotations

import math

import torch


def shapes(cfg: dict, in_features: int, head_in: int) -> list:
    """(name, shape, kind) of every parameter of a 4-block net of ``cfg``
    whose first block reads ``in_features`` and whose head reads
    ``head_in`` features."""
    out = []
    widths = [in_features, *cfg["channels"]]
    for i, c in enumerate(cfg["channels"]):
        out += [(f"blocks.{i}.conv.kernel", (27, widths[i], c), "kernel"),
                (f"blocks.{i}.conv.bias", (c,), "bias"),
                (f"blocks.{i}.norm.weight", (c,), "scale"),
                (f"blocks.{i}.norm.bias", (c,), "bias")]
    dims = [head_in, *cfg["head_dims"]]
    for j, d in enumerate(cfg["head_dims"]):
        out += [(f"head.{j}.weight", (d, dims[j]), "linear"),
                (f"head.{j}.bias", (d,), "bias")]
    out += [("out.weight", (cfg["num_classes"], dims[-1]), "linear"),
            ("out.bias", (cfg["num_classes"],), "bias")]
    return out


def make(cfg: dict, in_features: int, head_in: int, seed: int,
         device) -> dict:
    """{name: f32 tensor on ``device``} drawn from ``seed``: one normal
    draw on the device, cut into the parameters."""
    spec = shapes(cfg, in_features, head_in)
    total = sum(math.prod(s) for _, s, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = z[off:off + n].reshape(shape)
        off += n
        if kind == "kernel":
            t = t / math.sqrt(27 * shape[1])
        elif kind == "linear":
            t = t / math.sqrt(shape[1])
        elif kind == "scale":
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.contiguous()
    return out
