"""Weight carry-over from the JAX package's parameter trees.

The JAX ``PointwiseSegmenter`` and ``PointwiseClassifier`` keep their
variables as nested dicts (``{"params": ..., "batch_stats": ...}``, as
``jax.device_get`` or ``flax.traverse_util`` give them); a ``.npz`` holds the
same arrays keyed by flattened path
("params/PointwiseConvBlock_0/PointwiseConv_0/kernel").
``segmenter_state_dict`` and ``classifier_state_dict`` map either form onto
the port's ``state_dict`` (the two nets share the layout):

  PointwiseConvBlock_i/PointwiseConv_0/{kernel,bias} -> blocks.i.conv.*
      (the kernel stays (27, Cin, Cout))
  PointwiseConvBlock_i/LayerNorm_0/{scale,bias}      -> blocks.i.norm.{weight,bias}
  PointwiseConvBlock_i/BatchNorm_0/{scale,bias}      -> blocks.i.norm.{weight,bias}
  batch_stats .../BatchNorm_0/{mean,var}              -> blocks.i.norm.running_{mean,var}
  Dense_j/{kernel,bias} -> head.j.* (the last Dense_j -> out.*); flax Dense
      kernels are (in, out), torch Linear weights (out, in)

No flax import: only numpy arrays cross over.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np
import torch

_NORM = {"LayerNorm_0": {"scale": "weight", "bias": "bias"},
         "BatchNorm_0": {"scale": "weight", "bias": "bias",
                         "mean": "running_mean", "var": "running_var"}}


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": np.ndarray}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def segmenter_state_dict(variables: Mapping) -> dict:
    """JAX segmenter variables (nested or flat "/"-keyed) -> torch
    ``state_dict`` of ``models.PointwiseSegmenter``."""
    return _state_dict(variables)


def classifier_state_dict(variables: Mapping) -> dict:
    """JAX classifier variables (nested or flat "/"-keyed) -> torch
    ``state_dict`` of ``models.PointwiseClassifier``."""
    return _state_dict(variables)


def _state_dict(variables: Mapping) -> dict:
    flat = flatten(variables)
    if not any(k.startswith(("params/", "batch_stats/")) for k in flat):
        flat = {f"params/{k}": v for k, v in flat.items()}   # bare params
    dense_ids = sorted({int(m.group(1)) for k in flat
                        if (m := re.match(r"params/Dense_(\d+)/", k))})
    if not dense_ids:
        raise ValueError("no Dense_* parameters: not a segmenter or "
                         "classifier tree")
    last = dense_ids[-1]
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if len(parts) == 3 and parts[1].startswith("Dense_"):
            j = int(parts[1][len("Dense_"):])
            name = "out" if j == last else f"head.{j}"
            sd[f"{name}.{'weight' if parts[2] == 'kernel' else 'bias'}"] = (
                t.T.contiguous() if parts[2] == "kernel" else t)
            continue
        m = re.fullmatch(r"(params|batch_stats)/PointwiseConvBlock_(\d+)/"
                         r"(\w+)/(\w+)", key)
        if m is None:
            raise ValueError(f"unrecognised parameter {key!r}")
        _, i, mod, leaf = m.groups()
        if mod == "PointwiseConv_0":
            sd[f"blocks.{i}.conv.{leaf}"] = t
        elif mod in _NORM and leaf in _NORM[mod]:
            sd[f"blocks.{i}.norm.{_NORM[mod][leaf]}"] = t
        else:
            raise ValueError(f"unrecognised parameter {key!r}")
    return sd


def load_segmenter(model: torch.nn.Module, variables: Mapping) -> None:
    """Load JAX segmenter variables into ``model`` (strict: every tensor of
    the model must be covered, and nothing else)."""
    model.load_state_dict(segmenter_state_dict(variables), strict=True)


def load_classifier(model: torch.nn.Module, variables: Mapping) -> None:
    """Load JAX classifier variables into ``model`` (strict)."""
    model.load_state_dict(classifier_state_dict(variables), strict=True)


def random_segmenter_params(in_features: int, num_classes: int, *,
                            channels: Sequence[int],
                            head_dims: Sequence[int], norm: str = "layer",
                            use_global_context: bool = False,
                            seed: int = 0) -> dict:
    """Random segmenter variables in the JAX layout (flat "/"-keyed numpy
    arrays) made from a numpy seed: fan-in-scaled normal weights, small
    random biases and norm parameters, so a served model exercises every
    tensor."""
    rng = np.random.RandomState(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def small(n, center=0.0):
        return (center + 0.1 * rng.standard_normal(n)).astype(np.float32)

    out = {}
    widths = [in_features, *channels]
    for i, c in enumerate(channels):
        blk = f"params/PointwiseConvBlock_{i}"
        out[f"{blk}/PointwiseConv_0/kernel"] = normal((27, widths[i], c),
                                                      27 * widths[i])
        out[f"{blk}/PointwiseConv_0/bias"] = small(c)
        if norm == "layer":
            out[f"{blk}/LayerNorm_0/scale"] = small(c, 1.0)
            out[f"{blk}/LayerNorm_0/bias"] = small(c)
        elif norm == "batch":
            out[f"{blk}/BatchNorm_0/scale"] = small(c, 1.0)
            out[f"{blk}/BatchNorm_0/bias"] = small(c)
            stats = f"batch_stats/PointwiseConvBlock_{i}/BatchNorm_0"
            out[f"{stats}/mean"] = small(c)
            out[f"{stats}/var"] = (1.0 + 0.1 * rng.rand(c)).astype(np.float32)
    head_in = sum(channels) + (2 * channels[-1] if use_global_context else 0)
    dims = [head_in, *head_dims, num_classes]
    for j in range(len(dims) - 1):
        out[f"params/Dense_{j}/kernel"] = normal((dims[j], dims[j + 1]),
                                                 dims[j])
        out[f"params/Dense_{j}/bias"] = small(dims[j + 1])
    return out
