"""Part-segmentation training under ``--dp``: the port's sharded step
against the JAX package's single-device step.

The JAX side is the unsharded ``Trainer`` (stateful under BatchNorm) on the
global batch.  The port's side runs the sums-contract ``Trainer`` with
``partseg_spmd_loss_fn`` on 2 spawned gloo ranks, each on half the clouds
with their categories (as tests/test_torch_spmd_batchnorm.py does for the
semantic segmenter).  Tolerances are tests/test_parallel.py's: loss rtol
1e-5, grad norm rtol 1e-3, parameters and running averages rtol 1e-4 /
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointwise_tpu.models import ShapeNetPartSegmenter as JaxPartSegmenter
from pointwise_tpu.models import segmentation_loss as jax_seg_loss
from pointwise_tpu.train import trainer as jax_trainer
from pointwise_tpu.train.configs import OptimizerConfig as JaxOpt
from pointwise_torch.convert import shapenetpart_state_dict
from pointwise_torch.parallel import launch
from pointwise_torch.train.configs import OptimizerConfig

RUN_LIMIT = 240       # seconds for one spawned run, start to end
PARTSEG = dict(num_parts=5, num_categories=3, channels=(8,), radii=(0.5,),
               head_dims=(8,), dropout_rate=0.0, precision="float32")
OPT = dict(warmup_steps=1, decay_steps=10)


def partseg_batch(seed=0, B=8, N=64):
    rng = np.random.RandomState(seed)
    return {"points": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            "category": rng.randint(0, 3, B).astype(np.int32),
            "label": rng.randint(0, 5, (B, N)).astype(np.int64),
            "mask": (rng.rand(B, N) > 0.2).astype(np.float32)}


def jax_partseg(norm):
    """(torch state_dict of the init, JAX metrics of two steps, torch
    state_dict after them) of the unsharded trainer, stateful under
    BatchNorm."""
    jm = JaxPartSegmenter(**PARTSEG, norm=norm, impl="reference")
    b = {k: jnp.asarray(v) for k, v in partseg_batch().items()}
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), b["points"],
                                       b["category"], mask=b["mask"]))

    def forward(variables, batch, mutable):
        out = jm.apply(variables, batch["points"], batch["category"],
                       mask=batch["mask"], train=True, mutable=mutable)
        logits, mut = out if mutable else (out, None)
        loss, acc = jax_seg_loss(logits, batch["label"], batch["mask"])
        return loss, {"accuracy": acc}, mut

    if norm == "batch":
        def loss_fn(p, ms, batch, rng, train):
            loss, m, mut = forward({"params": p, "batch_stats": ms}, batch,
                                   ["batch_stats"])
            return loss, (m, mut["batch_stats"])
    else:
        def loss_fn(p, batch, rng, train):
            loss, m, _ = forward({"params": p}, batch, False)
            return loss, m

    t = jax_trainer.Trainer(loss_fn, variables["params"], JaxOpt(**OPT),
                            donate=False,
                            model_state=variables.get("batch_stats"))
    metrics = [jax.device_get(t.step(b, jax.random.PRNGKey(2)))
               for _ in range(2)]
    after = {"params": jax.device_get(t.state.params)}
    if norm == "batch":
        after["batch_stats"] = jax.device_get(t.state.model_state)
    return (shapenetpart_state_dict(variables), metrics,
            shapenetpart_state_dict(after))


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_partseg_step_matches_jax_unsharded(tmp_path, norm):
    # --dp's layout: each rank holds half the clouds with their categories;
    # the loss weight is the global count of unmasked points
    init, want, want_state = jax_partseg(norm)
    res = launch.spawn(
        launch.train_worker, 2, str(tmp_path), data=2, space=1,
        timeout=RUN_LIMIT, device="cpu",
        kwargs=dict(kind="partseg", model_kwargs=dict(PARTSEG, norm=norm),
                    state=init, opt_cfg=OptimizerConfig(**OPT),
                    batches=[partseg_batch()] * 2, seeds=[0, 1]))
    for w, g in zip(want, res[0]["metrics"]):
        np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=1e-5)
        np.testing.assert_allclose(g["accuracy"], float(w["accuracy"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]),
                                   rtol=1e-3)
    assert res[1]["metrics"] == res[0]["metrics"]
    for k, v in want_state.items():
        if norm == "batch" and k.endswith("conv.bias"):
            # BatchNorm removes any constant shift: this gradient is zero
            # up to rounding, which Adam scales to full-size steps
            continue
        np.testing.assert_allclose(res[0]["state"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
