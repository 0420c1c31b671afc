"""The port's exact streaming engine, on the CPU.

Streamed logits must equal the port's direct full-scene forward and the JAX
engine's output for the same weights (cf. tests/test_native_streaming.py);
the schedule coalescing must survive the double-pop schedule; length
profiles must be reused across calls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.streaming import stream_apply_layered as jax_layered
from pointwise_torch import streaming
from pointwise_torch.convert import load_segmenter, random_segmenter_params
from pointwise_torch.data import synthetic
from pointwise_torch.infer import layered_apply
from pointwise_torch.models import PointwiseSegmenter

RADII = (0.25, 0.5)
KW = dict(radii=RADII, tile_size=2.0, out_dim=5, buckets=(256, 512, 1024),
          tile_batch=2)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def setup():
    flat = random_segmenter_params(3, 5, channels=(8, 8), head_dims=(16,),
                                   seed=11)
    tm = PointwiseSegmenter(5, 3, channels=(8, 8), radii=RADII,
                            head_dims=(16,), dropout_rate=0.0,
                            precision="float32", use_global_context=False,
                            device="cpu").eval()
    load_segmenter(tm, flat)
    return flat, tm


def _direct(tm, xyz, feats):
    with torch.no_grad():
        return tm(torch.from_numpy(xyz[None]), torch.from_numpy(feats[None]),
                  torch.ones(1, len(xyz)))[0].numpy()


def test_layered_matches_direct_and_jax_engine(setup):
    flat, tm = setup
    xyz, rgb, _ = synthetic.segmentation_scene(3, num_objects=3,
                                               points_per_obj=128)
    direct = _direct(tm, xyz, rgb)
    ev = {}
    streamed = streaming.stream_apply_layered(
        layered_apply(tm), xyz, rgb, device="cpu", events=ev, **KW)
    np.testing.assert_allclose(streamed, direct, rtol=2e-4, atol=2e-4)
    assert ev["n_jobs"] >= 2 and ev["total_s"] > 0

    jm = JaxSegmenter(num_classes=5, channels=(8, 8), radii=RADII,
                      head_dims=(16,), impl="reference", dropout_rate=0.0,
                      precision="float32", use_global_context=False)
    variables = _unflatten(flat)

    @functools.partial(jax.jit, static_argnums=(5,))
    def apply_j(pts, fts, cnt, sels, skips, lengths):
        return jm.apply(variables, pts, fts, cnt, sels, skips,
                        lengths=lengths, method="streaming_logits")

    want = jax_layered(apply_j, xyz, rgb, **KW)
    np.testing.assert_allclose(streamed, want, rtol=2e-4, atol=2e-4)


def _coalesce_unguarded(groups):
    """The coalescing loop as it stood in the JAX engine (no guard)."""
    cost = streaming._sched_cost
    kept = []
    for k in sorted((k for k in groups if not isinstance(k, int)),
                    key=cost, reverse=True):
        for i, kk in enumerate(kept):
            m = tuple(max(a, c) for a, c in zip(kk, k))
            if cost(m) <= 1.10 * cost(k):
                members = groups.pop(k) + groups.pop(kk)
                groups.setdefault(m, []).extend(members)
                kept[i] = m
                kept = list(dict.fromkeys(kept))
                break
        else:
            kept.append(k)


def test_coalesce_survives_double_pop_schedule():
    # The max of the first two schedules equals the key visited third, so
    # that key is already kept when the loop reaches it: unguarded, it is
    # popped twice (KeyError).  Zero-cost keys make the merge order a tie.
    def groups():
        return {(0, 0, 7): ["a"], (5, 0, 0): ["b"], (5, 0, 7): ["c"], 512: ["d"]}

    with pytest.raises(KeyError):
        _coalesce_unguarded(groups())
    g = groups()
    streaming._coalesce(g)
    assert g == {(5, 0, 7): ["c", "b", "a"], 512: ["d"]}


def test_coalesce_merges_close_schedules_only():
    g = {(8192, 4096): [1], (8192, 4000): [2], (16384, 16384): [3]}
    streaming._coalesce(g)
    assert sorted(g) == [(8192, 4096), (16384, 16384)]
    assert sorted(g[(8192, 4096)]) == [1, 2]


def test_length_profiles_reused(setup):
    _, tm = setup
    apply = layered_apply(tm)
    big, rgb_b, _ = synthetic.segmentation_scene(6, num_objects=4,
                                                 points_per_obj=128)
    small, rgb_s, _ = synthetic.segmentation_scene(7, num_objects=2,
                                                   points_per_obj=96)
    profiles = {}
    streaming.stream_apply_layered(apply, big, rgb_b, device="cpu",
                                   length_profiles=profiles, **KW)
    assert profiles
    for b, (tbs, lengths) in profiles.items():
        assert tbs >= 1 and len(lengths) == len(RADII) + 1
        assert list(lengths) == sorted(lengths, reverse=True)
    before = dict(profiles)
    out = streaming.stream_apply_layered(apply, small, rgb_s, device="cpu",
                                         length_profiles=profiles, **KW)
    # covered keys keep their (larger) schedules: no new shapes
    for b in before:
        if b in profiles:
            assert all(x >= y for x, y in zip(profiles[b][1], before[b][1]))
    np.testing.assert_allclose(out, _direct(tm, small, rgb_s),
                               rtol=2e-4, atol=2e-4)


def test_bucket_for():
    assert streaming._bucket_for(3, (4, 8)) == 4
    assert streaming._bucket_for(8, (4, 8)) == 8
    assert streaming._bucket_for(17, (4, 8)) == 32


def test_device_and_mesh_requests():
    xyz = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="requires a mesh"):
        streaming.stream_apply_layered(None, xyz, xyz, scene_axis="space",
                                       device="cpu", **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            streaming.stream_apply_layered(None, xyz, xyz, **KW)
