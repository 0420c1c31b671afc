"""The port's masked BatchNorm in training held against the JAX package's.

``MaskedBatchNorm`` (and a conv block with ``norm='batch'``) in training
mode against the JAX module applied with ``mutable=['batch_stats']``, on
the same numpy inputs with padded rows masked: outputs within 1e-5, the new
running averages within 1e-6, and the gradients of a scalar loss against
``jax.grad`` within 1e-4, all in f32.  Then one trainer step of a
segmenter with ``norm='batch'`` against the JAX trainer's stateful step,
and the train CLI's ``--norm batch`` run resumed bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.models import segmentation_loss as jax_seg_loss
from pointwise_tpu.models.layers import MaskedBatchNorm as JaxBN
from pointwise_tpu.models.layers import PointwiseConvBlock as JaxBlock
from pointwise_tpu.train import trainer as jax_trainer
from pointwise_tpu.train.configs import OptimizerConfig
from pointwise_torch.convert import segmenter_state_dict
from pointwise_torch.models import (MaskedBatchNorm, PointwiseConvBlock,
                                    PointwiseSegmenter, segmentation_loss)
from pointwise_torch.train import trainer as tt
from test_torch_train_cli import assert_resumed_run_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn_variables(rng, c):
    return {"params": {"scale": (0.5 + rng.rand(c)).astype(np.float32),
                       "bias": rng.standard_normal(c).astype(np.float32)},
            "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                            "var": (0.5 + rng.rand(c)).astype(np.float32)}}


def _load_bn(bn, v):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_masked_batchnorm_training_matches_jax(masked):
    rng = np.random.RandomState(0)
    c = 7
    x = (rng.standard_normal((3, 50, c)) * 2 + 1).astype(np.float32)
    mask = (rng.rand(3, 50) > 0.3).astype(np.float32) if masked else None
    if masked:
        x[mask == 0] = 10.0         # padding rows must not move the moments
    g = rng.standard_normal(x.shape).astype(np.float32)
    v = _bn_variables(rng, c)
    jbn = JaxBN(use_running_average=False)
    y_want, mut = jbn.apply(v, x, mask, mutable=["batch_stats"])

    def loss(params, x):
        y, _ = jbn.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, x, mask,
                         mutable=["batch_stats"])
        return jnp.sum(y * g)

    d_params, d_x = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    bn = MaskedBatchNorm(c)
    _load_bn(bn, v)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn.train()(xt, None if mask is None else torch.from_numpy(mask))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    for got, want in ((xt.grad, d_x), (bn.weight.grad, d_params["scale"]),
                      (bn.bias.grad, d_params["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    # evaluation reads the running averages and leaves them alone
    before = bn.running_mean.clone()
    y_eval = bn.eval()(torch.from_numpy(x))
    want_eval = jbn.clone(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": mut["batch_stats"]}, x, mask)
    np.testing.assert_allclose(y_eval.detach().numpy(),
                               np.asarray(want_eval), rtol=0, atol=1e-5)
    assert torch.equal(before, bn.running_mean)


def test_all_masked_rows_keep_the_count_at_one():
    # an empty batch: cnt clamps to 1, the moments are 0 and the variance
    # is clamped at 0, as in the JAX module
    x = np.random.RandomState(1).standard_normal((2, 5, 4)).astype(np.float32)
    mask = np.zeros((2, 5), np.float32)
    v = _bn_variables(np.random.RandomState(2), 4)
    y_want, mut = JaxBN(use_running_average=False).apply(
        v, x, mask, mutable=["batch_stats"])
    bn = MaskedBatchNorm(4)
    _load_bn(bn, v)
    y = bn.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)


def test_conv_block_with_batch_norm_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.uniform(0, 1, (2, 96, 3)).astype(np.float32)
    x = rng.standard_normal((2, 96, 5)).astype(np.float32)
    mask = (rng.rand(2, 96) > 0.25).astype(np.float32)
    g = rng.standard_normal((2, 96, 8)).astype(np.float32)
    jb = JaxBlock(8, 0.4, impl="reference", norm="batch",
                  precision="float32")
    variables = jb.init(jax.random.PRNGKey(0), pts, x, mask, train=False)
    y_want, mut = jb.apply(variables, pts, x, mask, train=True,
                           mutable=["batch_stats"])

    def loss(params, x):
        y, _ = jb.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        pts, x, mask, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g)

    d_params, d_x = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    tb = PointwiseConvBlock(5, 8, 0.4, norm="batch", precision="float32")
    p = jax.device_get(variables["params"])
    with torch.no_grad():
        tb.conv.kernel.copy_(torch.from_numpy(
            np.array(p["PointwiseConv_0"]["kernel"])))
        tb.conv.bias.copy_(torch.from_numpy(
            np.array(p["PointwiseConv_0"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tb.train()(torch.from_numpy(pts), xt, torch.from_numpy(mask))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want),
                               rtol=0, atol=1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tb.norm.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.norm.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)
    for got, want in (
            (xt.grad, d_x),
            (tb.conv.kernel.grad, d_params["PointwiseConv_0"]["kernel"]),
            (tb.norm.weight.grad, d_params["BatchNorm_0"]["scale"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


def test_trainer_step_with_batch_norm_matches_jax():
    # two steps of the stateful JAX trainer and of the port's: the loss, the
    # grad norm and the running averages the steps leave (one update per
    # step: nothing runs the training forward twice)
    rng = np.random.RandomState(4)
    batch = {"points": rng.uniform(0, 1.2, (2, 128, 3)).astype(np.float32),
             "features": rng.uniform(0, 1, (2, 128, 6)).astype(np.float32),
             "label": rng.randint(0, 5, (2, 128)).astype(np.int32),
             "mask": (rng.rand(2, 128) > 0.2).astype(np.float32)}
    kw = dict(num_classes=5, channels=(8, 8), radii=(0.3, 0.6),
              head_dims=(16,), dropout_rate=0.0, norm="batch",
              precision="float32", use_global_context=False)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    jm = JaxSegmenter(**kw, impl="reference")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), jb["points"],
                                       jb["features"], jb["mask"]))

    def jax_loss(p, ms, b, rng, train):
        logits, mut = jm.apply({"params": p, "batch_stats": ms},
                               b["points"], b["features"], b["mask"],
                               train=True, mutable=["batch_stats"])
        loss, acc = jax_seg_loss(logits, b["label"], b["mask"])
        return loss, ({"accuracy": acc}, mut["batch_stats"])

    jt = jax_trainer.Trainer(jax_loss, variables["params"], opt, donate=False,
                             model_state=variables["batch_stats"])
    want = [jax.device_get(jt.step(jb, jax.random.PRNGKey(0)))
            for _ in range(2)]
    tm = PointwiseSegmenter(in_features=6, **kw)
    tm.load_state_dict(segmenter_state_dict(variables))

    def torch_loss(model, b, generator, train):
        logits = model(b["points"], b["features"], b["mask"])
        loss, acc = segmentation_loss(logits, b["label"], b["mask"])
        return loss, {"accuracy": acc}

    trainer = tt.Trainer(tm, torch_loss, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [trainer.step(tb, 0) for _ in range(2)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(g["grad_norm"]),
                                   float(w["grad_norm"]), rtol=1e-4)
    stats = segmenter_state_dict(
        {"batch_stats": jax.device_get(jt.state.model_state),
         "params": jax.device_get(jt.state.params)})
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_resume_with_batch_norm_is_bitwise_equal(tmp_path):
    # the running averages are part of the state and resume with it; small
    # rooms keep the 124-wide trunk cheap on the CPU
    rng = np.random.RandomState(0)
    rooms = tmp_path / "rooms"
    rooms.mkdir()
    for i in range(2):
        n = 700
        np.save(rooms / f"room{i}.npy", np.concatenate(
            [rng.uniform(0, 1.5, (n, 3)), rng.uniform(0, 1, (n, 3)),
             rng.randint(0, 5, (n, 1))], 1).astype(np.float32))
    state = assert_resumed_run_equal(
        ["--config", "seg_tiny_local", "--norm", "batch", "--data-dir",
         os.fspath(rooms), "--device", "cpu"], tmp_path)
    stats = [k for k in state if k.endswith("running_var")]
    assert len(stats) == 4
    assert all(not torch.equal(state[k], torch.ones_like(state[k]))
               for k in stats)
