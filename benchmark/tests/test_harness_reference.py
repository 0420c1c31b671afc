"""The plain reference against the program's plain CPU path in float32 at
a tiny size (the program is imported here, in the test, never by the
reference)."""

from __future__ import annotations


import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.cell import load_json, port_config
from benchmark.reference import conv as ref_conv
from benchmark.reference import models as ref_models

from conftest import ROOT

TOL = 2e-5


def _cfg(name):
    return load_json(ROOT, f"benchmark/configs/{name}.json")


def _close(a, b, tol=TOL):
    a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach()
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_conv_and_its_gradient_match_the_programs_spec():
    from pointwise_torch.ops.reference import pointwise_conv_reference

    torch.manual_seed(0)
    pts = torch.rand(2, 96, 3)
    feats = torch.randn(2, 96, 5, requires_grad=True)
    w = (0.2 * torch.randn(27, 5, 7)).requires_grad_(True)
    b = torch.randn(7, requires_grad=True)
    mask = torch.ones(2, 96)
    mask[1, 70:] = 0
    g = torch.randn(2, 96, 7)
    got = ref_conv.cloud_conv(pts, feats, w, b, 0.3, mask)
    want = pointwise_conv_reference(pts, feats, w, b, radius=0.3, mask=mask)
    _close(got, want)
    d_got = torch.autograd.grad((got * g).sum(), (feats, w, b))
    d_want = torch.autograd.grad((want * g).sum(), (feats, w, b))
    for a, c in zip(d_got, d_want):
        _close(a, c)
    scene = ref_conv.scene_conv(pts[0] * 3, feats[0].detach(), w.detach(),
                                b.detach(), 0.5)
    _close(scene, pointwise_conv_reference(pts[0] * 3, feats[0].detach(),
                                           w.detach(), b.detach(),
                                           radius=0.5))


def test_segmenter_matches_the_program_in_float32(tiny_rooms):
    from pointwise_torch import infer

    cfg = _cfg("s3dis_seg")
    mix = dict(traffic.load("serve_scans_200k"), base_scenes=1)
    scenes = traffic.base_scenes(cfg, mix, 5)
    xyz, feats = traffic.scan_request(cfg, mix, scenes, 5, 0)
    w = weights.make(cfg, 6, sum(cfg["channels"]), 9, "cpu")
    model = infer.build_model(port_config(cfg), torch.device("cpu"),
                              precision="float32")
    model.load_state_dict(w, strict=True)
    with torch.no_grad():
        want = model(torch.from_numpy(xyz)[None],
                     torch.from_numpy(feats)[None])[0]
    got = ref_models.segmenter_scene_logits(
        w, cfg["radii"], torch.from_numpy(xyz), torch.from_numpy(feats))
    _close(got, want)


@pytest.mark.parametrize("name,mix_name", [("s3dis_seg", "train_blocks"),
                                           ("modelnet40_cls",
                                            "train_clouds")])
def test_training_steps_match_the_program_in_float32(tiny_rooms, name,
                                                     mix_name):
    """Three steps of the program's trainer (convs switched to float32)
    against the reference's, with the same augmentation and dropout
    draws."""
    from pointwise_torch.data import pipeline
    from pointwise_torch.train import cli
    from pointwise_torch.train.trainer import step_seed

    from benchmark import train as train_loop

    small = {"s3dis_seg": {"batch_size": 2, "num_points": 128},
             "modelnet40_cls": {"batch_size": 4, "num_points": 64}}[name]
    cfg = dict(_cfg(name), **small)
    mix = dict(traffic.load(mix_name), pool_batches=3)
    pool = traffic.batch_pool(cfg, mix, 21)
    pcfg = port_config(cfg)
    build = (cli.build_classifier if cfg["net"] == "classifier"
             else cli.build_segmenter)
    model, loss_fn = build(pcfg, torch.device("cpu"))
    for blk in model.blocks:
        blk.conv.precision = "float32"
    cin, head_in = train_loop._net_inputs(cfg)
    w = weights.make(cfg, cin, head_in, 4, "cpu")
    model.load_state_dict(w, strict=True)
    trainer = cli._trainer(model, loss_fn, None, pcfg, None)
    feed = pipeline.prefetch_to_device(iter(pool), torch.device("cpu"))
    losses = []
    for s in range(3):
        losses.append(float(trainer.step(next(feed), step_seed(21, s))
                            ["loss"]))
        if s == 0:
            grad = {k: trainer.optimizer.state[p]["exp_avg"] / 0.1
                    for k, p in model.named_parameters()}
    ref = train_loop.reference_steps(cfg, pool, 21, w, 3, torch.device("cpu"))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in model.named_parameters():
        _close(grad[k], ref["grad"][k], 1e-5)
        # an element whose gradient is near zero moves under Adam by its
        # sign, which rounding decides: the change is held by its norm
        change = torch.linalg.vector_norm(p.detach() - w[k])
        assert float(change) == pytest.approx(
            float(torch.linalg.vector_norm(ref["change"][k])), rel=1e-4)
