"""Weight carry-over from the JAX package's parameter trees.

The JAX ``PointwiseSegmenter``, ``PointwiseClassifier`` and
``ShapeNetPartSegmenter`` keep their variables as nested dicts
(``{"params": ..., "batch_stats": ...}``, as ``jax.device_get`` or
``flax.traverse_util`` give them); a ``.npz`` holds the same arrays keyed by
flattened path ("params/PointwiseConvBlock_0/PointwiseConv_0/kernel").
``segmenter_state_dict``, ``classifier_state_dict`` and
``shapenetpart_state_dict`` map either form onto the port's ``state_dict``
(the nets share the layout):

  PointwiseConvBlock_i/PointwiseConv_0/{kernel,bias} -> blocks.i.conv.*
      (the kernel stays (27, Cin, Cout))
  PointwiseConvBlock_i/LayerNorm_0/{scale,bias}      -> blocks.i.norm.{weight,bias}
  PointwiseConvBlock_i/BatchNorm_0/{scale,bias}      -> blocks.i.norm.{weight,bias}
  batch_stats .../BatchNorm_0/{mean,var}              -> blocks.i.norm.running_{mean,var}
  Dense_j/{kernel,bias} -> head.j.* (the last Dense_j -> out.*); flax Dense
      kernels are (in, out), torch Linear weights (out, in); in the part
      segmenter Dense_0 is the category embedding (flax names it first) ->
      embed.*, and the head starts at Dense_1

No flax import: only numpy arrays cross over.
"""

from __future__ import annotations

import functools
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


def shapenetpart_state_dict(variables: Mapping) -> dict:
    """JAX part-segmenter variables (nested or flat "/"-keyed) -> torch
    ``state_dict`` of ``models.ShapeNetPartSegmenter``."""
    return _state_dict(variables, embed=True)


def _state_dict(variables: Mapping, embed: bool = False) -> dict:
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
            if j == last:
                name = "out"
            elif embed:
                name = "embed" if j == 0 else f"head.{j - 1}"
            else:
                name = f"head.{j}"
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


def load_shapenetpart(model: torch.nn.Module, variables: Mapping) -> None:
    """Load JAX part-segmenter variables into ``model`` (strict)."""
    model.load_state_dict(shapenetpart_state_dict(variables), strict=True)


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
    out = _random_trunk(rng, in_features, channels, norm)
    head_in = sum(channels) + (2 * channels[-1] if use_global_context else 0)
    _random_dense(rng, out, [head_in, *head_dims, num_classes])
    return out


def random_shapenetpart_params(num_parts: int, num_categories: int, *,
                               channels: Sequence[int],
                               head_dims: Sequence[int], in_features: int = 3,
                               norm: str = "layer", seed: int = 0) -> dict:
    """Random part-segmenter variables in the JAX layout, as
    ``random_segmenter_params``: Dense_0 is the 64-wide category
    embedding, Dense_1.. the head, the last Dense the out layer."""
    rng = np.random.RandomState(seed)
    out = _random_trunk(rng, in_features, channels, norm)
    _random_dense(rng, out, [num_categories, 64])
    _random_dense(rng, out, [sum(channels) + 2 * channels[-1] + 64,
                             *head_dims, num_parts], first=1)
    return out


def _normal(rng, shape, fan_in):
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _small(rng, n, center=0.0):
    return (center + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _random_dense(rng, out: dict, dims, first: int = 0) -> None:
    """Dense_{first + j} (dims[j] -> dims[j + 1]) for each j."""
    for j in range(len(dims) - 1):
        out[f"params/Dense_{first + j}/kernel"] = _normal(
            rng, (dims[j], dims[j + 1]), dims[j])
        out[f"params/Dense_{first + j}/bias"] = _small(rng, dims[j + 1])


def _random_trunk(rng, in_features, channels, norm) -> dict:
    """The conv blocks' variables (and batch_stats for norm='batch')."""
    normal = functools.partial(_normal, rng)
    small = functools.partial(_small, rng)
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
    return out
