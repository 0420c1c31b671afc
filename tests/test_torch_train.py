"""The port's training path held against the JAX package's on the CPU.

Parameters come from one numpy seed (or a flax init) and carry over through
convert.py; batches are numpy arrays handed to both frameworks.  The JAX
models run the Pallas op in interpret mode (``impl='auto'`` on the CPU);
the port runs the plain versions of its kernels behind
``PointwiseConvFunction``.

Tolerances.  f32: loss rtol 1e-5, grad norm rtol 1e-4, parameters atol
1e-5 after three AdamW steps at lr 1e-2 (the sums run in another order;
measured differences are ~1e-6).  bf16: loss rtol 1e-4, grad norm rtol
1e-3, parameters atol 1e-3, a tenth of one step's size: both sides round
at the same points, but a rounded mean or per-cell sum can sit one bf16
ulp apart, and Adam's normalised step turns a small relative gradient
difference into a parameter difference of up to a fraction of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointwise_tpu.models import PointwiseClassifier as JaxClassifier
from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.models import classification_loss as jax_cls_loss
from pointwise_tpu.models import segmentation_loss as jax_seg_loss
from pointwise_tpu.models import segmentation_loss_sums as jax_seg_loss_sums
from pointwise_tpu.train import trainer as jax_trainer
from pointwise_tpu.train.configs import OptimizerConfig
from pointwise_torch.convert import (classifier_state_dict, load_classifier,
                                     load_segmenter, random_segmenter_params,
                                     segmenter_state_dict)
from pointwise_torch.models import (PointwiseClassifier, PointwiseSegmenter,
                                    classification_loss, segmentation_loss,
                                    segmentation_loss_sums)
from pointwise_torch.train import trainer as tt

CH, RADII, HEAD, NCLS = (8, 8), (0.3, 0.6), (16,), 5
OPT = OptimizerConfig(learning_rate=1e-2, warmup_steps=2, decay_steps=10,
                      grad_clip=0.5)
TOL = {"float32": dict(loss=1e-5, norm=1e-4, params=1e-5),
       "bfloat16": dict(loss=1e-4, norm=1e-3, params=1e-3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CPU paths run many small ops; with the test workers sharing the
    # cores, more intra-op threads only add contention
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _seg_batch(seed=0, b=2, n=200):
    rng = np.random.RandomState(seed)
    return {"points": rng.uniform(0, 1.2, (b, n, 3)).astype(np.float32),
            "features": rng.uniform(0, 1, (b, n, 6)).astype(np.float32),
            "label": rng.randint(0, NCLS, (b, n)).astype(np.int32),
            "mask": (rng.rand(b, n) > 0.2).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_params(got_sd, want_sd, atol):
    assert sorted(got_sd) == sorted(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_trainer_matches_jax(precision):
    # a narrow segmenter, one batch with a partial mask, three steps: the
    # first two clip (grad norm above 0.5), the third does not
    tol = TOL[precision]
    flat = random_segmenter_params(6, NCLS, channels=CH, head_dims=HEAD,
                                   seed=0)
    batch = _seg_batch()
    jm = JaxSegmenter(num_classes=NCLS, channels=CH, radii=RADII,
                      head_dims=HEAD, dropout_rate=0.0, impl="auto",
                      precision=precision, use_global_context=False)

    def jax_loss(p, b, rng, train):
        logits = jm.apply({"params": p}, b["points"], b["features"],
                          b["mask"], train=train, rngs={"dropout": rng})
        loss, acc = jax_seg_loss(logits, b["label"], b["mask"])
        return loss, {"accuracy": acc}

    jt = jax_trainer.Trainer(jax_loss, _unflatten(flat)["params"], OPT,
                             donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = [jax.device_get(jt.step(jb, jax.random.PRNGKey(0)))
            for _ in range(3)]

    tm = PointwiseSegmenter(NCLS, 6, channels=CH, radii=RADII,
                            head_dims=HEAD, dropout_rate=0.0,
                            precision=precision, use_global_context=False,
                            device="cpu")
    load_segmenter(tm, flat)

    def torch_loss(model, b, generator, train):
        logits = model(b["points"], b["features"], b["mask"])
        loss, acc = segmentation_loss(logits, b["label"], b["mask"])
        return loss, {"accuracy": acc}

    trainer = tt.Trainer(tm, torch_loss, OPT)
    tb = _torch_batch(batch)
    got = [trainer.step(tb, 0) for _ in range(3)]
    norms = []
    for w, g in zip(want, got):
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]),
                                   rtol=tol["loss"])
        np.testing.assert_allclose(float(g["grad_norm"]),
                                   float(w["grad_norm"]), rtol=tol["norm"])
        assert float(g["accuracy"]) == pytest.approx(float(w["accuracy"]))
        norms.append(float(g["grad_norm"]))
    assert norms[0] > OPT.grad_clip > norms[2]       # both clip branches
    _assert_params(tm.state_dict(), segmenter_state_dict(
        {"params": jax.device_get(jt.state.params)}), tol["params"])


def test_classifier_matches_jax():
    jm = JaxClassifier(num_classes=4, channels=CH, radii=(0.5, 1.0),
                       head_dims=HEAD, dropout_rate=0.0, impl="auto",
                       precision="float32")
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1, 1, (3, 64, 3)).astype(np.float32)
    labels = np.array([0, 3, 1], np.int32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), pts))
    tm = PointwiseClassifier(4, channels=CH, radii=(0.5, 1.0),
                             head_dims=HEAD, dropout_rate=0.0,
                             precision="float32", device="cpu")
    load_classifier(tm, variables)
    want = np.asarray(jm.apply(variables, pts))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(pts)).numpy()
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def jax_loss(p, b, rng, train):
        loss, acc = jax_cls_loss(jm.apply({"params": p}, b["points"]),
                                 b["label"])
        return loss, {"accuracy": acc}

    def torch_loss(model, b, generator, train):
        loss, acc = classification_loss(model(b["points"]), b["label"])
        return loss, {"accuracy": acc}

    jt = jax_trainer.Trainer(jax_loss, variables["params"], OPT, donate=False)
    mj = jax.device_get(jt.step({"points": jnp.asarray(pts),
                                 "label": jnp.asarray(labels)},
                                jax.random.PRNGKey(0)))
    trainer = tt.Trainer(tm, torch_loss, OPT)
    mt = trainer.step({"points": torch.from_numpy(pts),
                       "label": torch.from_numpy(labels)}, 0)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    _assert_params(tm.state_dict(), classifier_state_dict(
        {"params": jax.device_get(jt.state.params)}), 1e-5)


def test_losses_match_jax():
    rng = np.random.RandomState(2)
    logits = rng.standard_normal((2, 30, 5)).astype(np.float32) * 3
    labels = rng.randint(0, 5, (2, 30)).astype(np.int32)
    mask = (rng.rand(2, 30) > 0.3).astype(np.float32)
    weights = rng.uniform(0.2, 2.0, 5).astype(np.float32)
    t = torch.from_numpy
    for m in (None, mask):
        for w in (None, weights):
            want = jax_seg_loss(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m),
                                class_weights=None if w is None
                                else jnp.asarray(w))
            got = segmentation_loss(t(logits), t(labels),
                                    None if m is None else t(m),
                                    class_weights=None if w is None else t(w))
            for a, b in zip(got, want):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    want = jax_seg_loss_sums(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.asarray(mask), jnp.asarray(weights))
    got = segmentation_loss_sums(t(logits), t(labels), t(mask), t(weights))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(float(got[2]["accuracy"]),
                               float(want[2]["accuracy"]), rtol=1e-6)
    want = jax_cls_loss(jnp.asarray(logits[0]), jnp.asarray(labels[0]))
    got = classification_loss(t(logits[0]), t(labels[0]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_lr_schedule_matches_optax():
    cfg = OptimizerConfig(learning_rate=3e-3, warmup_steps=10,
                          decay_steps=100, min_lr_ratio=0.05)
    want = optax.warmup_cosine_decay_schedule(
        init_value=cfg.learning_rate * 0.01, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps, decay_steps=cfg.decay_steps,
        end_value=cfg.learning_rate * cfg.min_lr_ratio)
    params = [torch.nn.Parameter(torch.zeros(3))]
    opt, schedule = tt.make_optimizer(params, cfg)
    assert opt.param_groups[0]["lr"] == pytest.approx(float(want(0)))
    for step in (0, 1, 5, 10, 11, 55, 100, 150):
        np.testing.assert_allclose(schedule(step), float(want(step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 1e3], ids=["below", "above"])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(3)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((4, 5), (5,), (27, 2, 3))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tt.clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(norm),
                               float(optax.global_norm(grads)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if scale < 1:       # below the threshold: untouched, bit for bit
        for a, g in zip(got, grads):
            np.testing.assert_array_equal(a.numpy(), g)


def test_adamw_matches_optax_with_decay_on_every_parameter():
    cfg = OptimizerConfig(learning_rate=1e-2, weight_decay=0.1,
                          warmup_steps=1, decay_steps=10, grad_clip=1.0)
    rng = np.random.RandomState(4)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * s
              for k, v in p0.items()} for s in (0.1, 5.0)]
    tx = jax_trainer.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt, schedule = tt.make_optimizer(list(params.values()), cfg)
    assert all(g["weight_decay"] == cfg.weight_decay
               for g in opt.param_groups)
    for step, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        tt.clip_by_global_norm([p.grad for p in params.values()],
                               cfg.grad_clip)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
