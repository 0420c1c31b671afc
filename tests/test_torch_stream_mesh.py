"""Parallel streaming: ``stream_apply_layered(mesh=..., scene_axis=...)`` on
spawned gloo ranks against the port's single-device engine and the JAX
engine on the 8-device CPU mesh of tests/conftest.py.

One segmenter (``seg_tiny_stream``, the config seed's weights, f32 convs)
streams two scenes; ``tile_batch=3`` so a data axis of 2 rounds the chunks
up to 4 tiles, with padding rows.  Tolerances: the port's sharded output
equals its single-device output within 1e-6 (the JAX engine's own pin,
tests/test_native_streaming.py), bit for bit under (space 2), where no
rank changes the rows it computes; it equals the JAX engine's output for
the same mesh shape within 2e-4 (tests/test_torch_streaming.py).  The
length profiles equal the JAX engine's for the same scenes and mesh shape,
and under a space axis each rank holds its half of the resident scene.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.parallel import make_mesh as jax_mesh
from pointwise_tpu.streaming import stream_apply_layered as jax_layered
from pointwise_torch import infer, streaming
from pointwise_torch.convert import random_segmenter_params
from pointwise_torch.data import synthetic
from pointwise_torch.parallel import launch
from pointwise_torch.train import get_config

CONFIG = "seg_tiny_stream"
KW = dict(tile_size=2.0, buckets=(256, 512, 1024), tile_batch=3)
RUN_LIMIT = 240       # seconds for one spawned run, start to end


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(CONFIG)
    scenes = []
    for seed, objects in ((11, 4), (12, 3)):
        xyz, rgb, _ = synthetic.segmentation_scene(seed, num_objects=objects,
                                                   points_per_obj=160)
        scenes.append((xyz, infer.scene_features(cfg, xyz, rgb)))
    model = infer.build_model(cfg, torch.device("cpu"), precision="float32")
    single = [streaming.stream_apply_layered(
        infer.layered_apply(model), xyz, feats, radii=cfg.radii,
        out_dim=cfg.num_classes, device="cpu", **KW)
        for xyz, feats in scenes]
    return cfg, scenes, single


def _jax_apply(cfg):
    flat = random_segmenter_params(cfg.in_features, cfg.num_classes,
                                   channels=cfg.channels,
                                   head_dims=cfg.head_dims, norm=cfg.norm,
                                   seed=0)
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    jm = JaxSegmenter(num_classes=cfg.num_classes, channels=cfg.channels,
                      radii=cfg.radii, head_dims=cfg.head_dims,
                      impl="reference", dropout_rate=0.0,
                      precision="float32", use_global_context=False)

    @functools.partial(jax.jit, static_argnums=(5,))
    def apply(pts, fts, cnt, sels, skips, lengths):
        return jm.apply(tree, pts, fts, cnt, sels, skips, lengths=lengths,
                        method="streaming_logits")

    return apply


@pytest.mark.parametrize("data,space", [(2, 1), (1, 2), (2, 2)],
                         ids=["data2", "space2", "data2_space2"])
def test_sharded_engine_matches_single_and_jax(setup, tmp_path, data, space):
    cfg, scenes, single = setup
    res = launch.spawn(launch.stream_worker, data * space, str(tmp_path),
                       data=data, space=space, device="cpu",
                       timeout=RUN_LIMIT,
                       kwargs=dict(config=CONFIG, scenes=scenes, **KW))
    for r in res:          # every rank returns the whole output
        for got, want in zip(r["outs"], single):
            if data == 1:
                np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert r["profiles"] == res[0]["profiles"]
        for scene, (xyz, feats) in zip(r["scenes"], scenes):
            rows = -(-len(xyz) // space)
            assert scene == {"points": len(xyz), "resident_bytes":
                             rows * (3 + feats.shape[1]) * 4}

    apply = _jax_apply(cfg)
    mesh = jax_mesh(data=data, space=space)
    profiles = {}
    for (xyz, feats), got in zip(scenes, res[0]["outs"]):
        want = jax_layered(apply, xyz, feats, radii=cfg.radii,
                           out_dim=cfg.num_classes, mesh=mesh,
                           scene_axis="space" if space > 1 else None,
                           length_profiles=profiles, **KW)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert res[0]["profiles"] == profiles
    # the mesh rounds every chunk up to a multiple of its data axis
    assert all(tbs % data == 0 for tbs, _ in profiles.values())
