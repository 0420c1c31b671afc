"""The port's segmenter and weight carry-over held against the JAX model.

The same weights (flax init, or numpy-seeded JAX-layout arrays) go through
convert.py into the PyTorch ``PointwiseSegmenter``; logits of ``__call__``
and ``streaming_logits`` must equal the JAX model's (f32 convs, 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_torch.convert import (flatten, load_segmenter,
                                     random_segmenter_params,
                                     segmenter_state_dict)
from pointwise_torch.models import PointwiseSegmenter

CH, RADII, HEAD, NCLS = (8, 8), (0.25, 0.5), (16,), 5


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _models(norm="layer", glob=True, impl="auto"):
    jm = JaxSegmenter(num_classes=NCLS, channels=CH, radii=RADII,
                      head_dims=HEAD, dropout_rate=0.0, norm=norm,
                      impl="reference", precision="float32",
                      use_global_context=glob)
    tm = PointwiseSegmenter(NCLS, 3, channels=CH, radii=RADII,
                            head_dims=HEAD, dropout_rate=0.0, norm=norm,
                            impl=impl, precision="float32",
                            use_global_context=glob, device="cpu").eval()
    return jm, tm


def _scene(seed=0, b=2, n=200):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1.5, (b, n, 3)).astype(np.float32)
    feats = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    mask = (rng.rand(b, n) > 0.2).astype(np.float32)
    return pts, feats, mask


@pytest.mark.parametrize("glob", [True, False], ids=["context", "local"])
def test_flax_init_carries_over(glob):
    jm, tm = _models(glob=glob)
    pts, feats, mask = _scene()
    variables = jax.device_get(
        jm.init(jax.random.PRNGKey(0), pts, feats, mask))
    load_segmenter(tm, variables)
    # kernels stay (27, Cin, Cout); Dense kernels transpose into Linear
    sd = segmenter_state_dict(variables)
    assert sd["blocks.0.conv.kernel"].shape == (27, 3, 8)
    flat = flatten(variables)
    np.testing.assert_array_equal(sd["head.0.weight"].numpy(),
                                  flat["params/Dense_0/kernel"].T)
    assert sd["out.weight"].shape == (NCLS, 16)
    want = np.asarray(jm.apply(variables, pts, feats, mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(feats),
                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("norm", ["layer", "batch", "none"])
def test_numpy_params_match_jax_layout(norm):
    # numpy-seeded JAX-layout params drive BOTH models: the layout is the one
    # flax applies, and batch_stats map onto the running averages
    jm, tm = _models(norm=norm, glob=False)
    flat = random_segmenter_params(3, NCLS, channels=CH, head_dims=HEAD,
                                   norm=norm, seed=7)
    load_segmenter(tm, flat)
    pts, feats, mask = _scene(1)
    want = np.asarray(jm.apply(_unflatten(flat), pts, feats, mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(feats),
                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_convert_rejects_foreign_trees():
    with pytest.raises(ValueError):
        segmenter_state_dict({"params": {"Conv_0": {"kernel": np.ones(3)}}})
    jm, tm = _models()
    flat = random_segmenter_params(3, NCLS, channels=CH, head_dims=HEAD,
                                   use_global_context=True, seed=1)
    flat.pop("params/PointwiseConvBlock_1/LayerNorm_0/scale")
    with pytest.raises(RuntimeError, match="Missing"):
        load_segmenter(tm, flat)


def _schedule(seed, b=2, lengths=(128, 96, 64)):
    rng = np.random.RandomState(seed)
    p0, p1, p2 = lengths
    counts = np.stack([[rng.randint(100, p0), rng.randint(70, p1),
                        rng.randint(40, p2)] for _ in range(b)]).astype(
        np.int32)
    sels = (np.sort(rng.randint(0, p0, (b, p1)), 1).astype(np.int32),
            np.sort(rng.randint(0, p1, (b, p2)), 1).astype(np.int32))
    skips = (rng.randint(0, p1, (b, p2)).astype(np.int32),
             rng.randint(0, p2, (b, p2)).astype(np.int32))
    return counts, sels, skips


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_streaming_logits_match_jax(impl):
    jm, tm = _models(glob=False, impl=impl)
    flat = random_segmenter_params(3, NCLS, channels=CH, head_dims=HEAD,
                                   seed=3)
    load_segmenter(tm, flat)
    lengths = (128, 96, 64)
    rng = np.random.RandomState(4)
    pts = rng.uniform(-0.7, 0.7, (2, lengths[0], 3)).astype(np.float32)
    feats = rng.uniform(0, 1, (2, lengths[0], 3)).astype(np.float32)
    counts, sels, skips = _schedule(5)
    want = np.asarray(jm.apply(
        _unflatten(flat), pts, feats, counts, sels, skips, lengths=lengths,
        method="streaming_logits"))
    t = torch.from_numpy
    with torch.no_grad():
        got = tm.streaming_logits(
            t(pts), t(feats), t(counts), tuple(map(t, sels)),
            tuple(map(t, skips)), lengths=lengths).numpy()
    assert got.shape == (2, lengths[-1], NCLS)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # slots past the interior count are zero
    for bi in range(2):
        assert np.all(got[bi, counts[bi, -1]:] == 0)
    with pytest.raises(ValueError, match="lengths"):
        tm.streaming_logits(t(pts), t(feats), t(counts), sels, skips,
                            lengths=lengths[:2])
