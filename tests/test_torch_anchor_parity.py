"""What the ``shapenetpart_hard`` anchor run draws, held against the JAX
package, at the anchor's own sizes.

The anchor protocol (``python -m pointwise_torch.tools.anchor_sweep
--config shapenetpart_hard --steps 1200``) trains each seed for 1,200
steps and scores instance mIoU.  The step tests hold one step's loss,
gradient and update to the JAX trainer on shared weights; these hold the
rest of the run: the hard variant's training and test sets for the seeds
the sweep draws and the epoch order over 1,200 steps (exact), the learning
rate at every one of those steps (optax, 1e-6), instance mIoU on identical
predictions (exact), the part segmenter's logits in the bf16 convs the
anchor trains with (the JAX Pallas op in interpret mode on the same
weights, 2e-2 of max |logit|: one bf16 ulp of a rounded mean may flip),
and the two random draws that cannot be shared, the
initial weights and the dropout masks, as distributions: the same keys,
shapes and truncated-normal scale per tensor, and the same keep share and
scale of a dropout mask.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointwise_torch.convert import load_shapenetpart, shapenetpart_state_dict
from pointwise_torch.data import shapenetpart as t_spp
from pointwise_torch.models import ShapeNetPartSegmenter
from pointwise_torch.train import get_config
from pointwise_torch.train import trainer as tt
from pointwise_tpu.data import shapenetpart as j_spp
from pointwise_tpu.models import ShapeNetPartSegmenter as JaxPartSegmenter

CFG = get_config("shapenetpart_hard")
STEPS = 1200          # the anchor protocol's --steps
SEEDS = range(6)      # the seeds of the anchor's six-seed run


def _sets_equal(a, b):
    for f in ("points", "category", "part"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.parts_per_category == b.parts_per_category


@pytest.mark.parametrize("seed", SEEDS)
def test_hard_training_set_and_epoch_order_equal_jax(seed):
    # --seed S draws the training set (its transforms, jitter and outliers)
    # and the epoch order; 1,200 steps of 8 clouds cover 38 epochs
    a = t_spp.load_shapenetpart(None, "train", CFG.num_points, seed=seed,
                                variant=CFG.variant)
    b = j_spp.load_shapenetpart(None, "train", CFG.num_points, seed=seed,
                                variant=CFG.variant)
    _sets_equal(a, b)
    per_epoch = len(a.category) // CFG.batch_size
    steps = 0
    for epoch in range(-(-STEPS // per_epoch)):
        for x, y in zip(t_spp.batches(a, CFG.batch_size, seed=seed + epoch),
                        j_spp.batches(b, CFG.batch_size, seed=seed + epoch),
                        strict=True):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
            steps += 1
    assert steps >= STEPS


def test_hard_test_set_and_instance_miou_equal_jax():
    # the eval's set (the config seed) and its metric on the same
    # predictions: right, confused within the category, and across them
    a = t_spp.load_shapenetpart(None, "test", CFG.num_points, seed=CFG.seed,
                                variant=CFG.variant)
    b = j_spp.load_shapenetpart(None, "test", CFG.num_points, seed=CFG.seed,
                                variant=CFG.variant)
    _sets_equal(a, b)
    rng = np.random.RandomState(11)
    label = a.part
    near = a.category[:, None] * 3 + rng.randint(0, 3, label.shape)
    for wrong in (0.1, 0.3):
        pred = np.where(rng.rand(*label.shape) < wrong, near, label)
        pred = np.where(rng.rand(*label.shape) < 0.02,
                        rng.randint(0, a.num_parts, label.shape), pred)
        assert t_spp.category_miou(pred, label, a.category,
                                   a.parts_per_category) == \
            j_spp.category_miou(pred, label, b.category,
                                b.parts_per_category)


def test_lr_schedule_over_the_anchor_run():
    # --steps shortens the run, not the schedule: both decay over the
    # config's decay_steps
    opt = CFG.optimizer
    want = optax.warmup_cosine_decay_schedule(
        init_value=opt.learning_rate * 0.01, peak_value=opt.learning_rate,
        warmup_steps=opt.warmup_steps, decay_steps=opt.decay_steps,
        end_value=opt.learning_rate * opt.min_lr_ratio)
    schedule = tt.lr_schedule(opt)
    steps = np.arange(STEPS + 1)
    # optax evaluates the warmup in f32 as (init - peak) * (1 - t) + peak,
    # the port in f64: they part by that sum's f32 rounding, at most two
    # ulps of the peak (8e-6 of the rate at step 0)
    np.testing.assert_allclose([schedule(int(s)) for s in steps],
                               np.asarray(want(steps)), rtol=1e-6,
                               atol=2 * np.spacing(np.float32(
                                   opt.learning_rate)))


def _models():
    kw = dict(num_parts=48, num_categories=16, channels=CFG.channels,
              radii=CFG.radii, head_dims=CFG.head_dims,
              dropout_rate=CFG.dropout, norm=CFG.norm)
    jm = JaxPartSegmenter(**kw, impl="reference", precision="float32")
    tm = ShapeNetPartSegmenter(**kw, in_features=CFG.in_features,
                               generator=torch.Generator().manual_seed(0))
    return jm, tm


def test_initial_weights_match_flax_as_a_distribution():
    # the draws differ (jax.random against torch.Generator), the law must
    # not: per tensor the same key and shape, lecun normal truncated at two
    # standard deviations for every weight (fan_in = 27 * Cin for a conv),
    # zeros and ones where flax puts them
    jm, tm = _models()
    pts = jnp.zeros((1, 64, 3))
    variables = jm.init(jax.random.PRNGKey(0), pts, jnp.zeros((1,), jnp.int32),
                        mask=jnp.ones((1, 64)))
    want = {k: np.asarray(v) for k, v in
            shapenetpart_state_dict(variables).items()}
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if g.ndim >= 2:     # a conv kernel or a Linear weight
            fan_in = int(np.prod(g.shape[:-1])) if g.ndim == 3 else g.shape[1]
            std = 1.0 / np.sqrt(fan_in)
            bound = 2.0 * std / 0.87962566103423978
            for x in (g, w):
                assert float(np.abs(x).max()) <= bound * (1 + 1e-6), k
                # sample std of n draws: within 5 / sqrt(n) of the law's
                tol = max(0.02, 5.0 / np.sqrt(x.size))
                assert abs(float(x.std()) / std - 1.0) <= tol, k
                assert abs(float(x.mean())) <= 5.0 * std / np.sqrt(x.size), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_dropout_masks_match_flax_as_a_distribution():
    # the head's dropout in training: kept with probability 1 - rate and
    # scaled by 1 / (1 - rate), in both
    rate = CFG.dropout
    _, tm = _models()
    tm.train()
    x = torch.ones(CFG.batch_size, CFG.num_points, CFG.head_dims[0])
    torch.manual_seed(0)
    got = tm.drop(x).numpy()
    want = np.asarray(fnn.Dropout(rate, deterministic=False).apply(
        {}, jnp.ones(x.shape), rngs={"dropout": jax.random.PRNGKey(0)}))
    n = x.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    for y in (got, want):
        kept = y != 0
        assert abs(float(kept.mean()) - (1 - rate)) <= 5 * sigma
        np.testing.assert_allclose(y[kept], 1.0 / (1 - rate), rtol=1e-6)


def test_bf16_logits_match_jax():
    kw = dict(num_parts=48, num_categories=16, channels=(16, 16, 16),
              radii=CFG.radii[:3], head_dims=(32,), dropout_rate=0.0,
              precision="bfloat16")
    rng = np.random.RandomState(5)
    pts = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    cat = np.array([3, 7], np.int32)
    mask = (rng.rand(2, 256) > 0.1).astype(np.float32)
    jm = JaxPartSegmenter(**kw, impl="pallas")
    j_in = (jnp.asarray(pts), jnp.asarray(cat))
    variables = jm.init(jax.random.PRNGKey(1), *j_in, mask=jnp.asarray(mask))
    want = np.asarray(jm.apply(variables, *j_in, mask=jnp.asarray(mask)))
    tm = ShapeNetPartSegmenter(**kw).eval()
    load_shapenetpart(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(cat),
                 mask=torch.from_numpy(mask)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 2e-2 * float(np.abs(want).max())
