"""BatchNorm training over a (data x space) mesh: the port against the JAX
package's single-device step.

The JAX side is the unsharded stateful ``Trainer`` (``model_state``
threading the batch statistics) on the global batch.  The port's side runs
the sums-contract ``Trainer`` on 2 spawned gloo ranks (as
tests/test_torch_spmd.py does), each on its shard of the same batch; a
model built under the mesh reduces its moments over all of it.  Data 2 is
``--dp``'s layout, space 2 ``--sp 2``'s.  Tolerances are
tests/test_parallel.py's (its BatchNorm pins): loss rtol 1e-5, grad norm
rtol 1e-3, running averages rtol 1e-4 / atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.models import segmentation_loss as jax_seg_loss
from pointwise_tpu.train import trainer as jax_trainer
from pointwise_tpu.train.configs import OptimizerConfig as JaxOpt
from pointwise_torch.convert import segmenter_state_dict
from pointwise_torch.parallel import launch
from pointwise_torch.train.configs import OptimizerConfig

RUN_LIMIT = 240       # seconds for one spawned run, start to end
SEG = dict(num_classes=3, channels=(8,), radii=(0.5,), head_dims=(8,),
           dropout_rate=0.0, precision="float32", norm="batch",
           use_global_context=False)
OPT = dict(warmup_steps=1, decay_steps=10)


def seg_batch(seed=0, B=8, N=64):
    rng = np.random.RandomState(seed)
    return {"points": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            "features": rng.standard_normal((B, N, 6)).astype(np.float32),
            "label": rng.randint(0, 3, (B, N)).astype(np.int64),
            "mask": (rng.rand(B, N) > 0.2).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def jax_bn_seg():
    """(torch state_dict of the init, JAX metrics of two steps, torch
    state_dict after them) of the unsharded stateful trainer."""
    jm = JaxSegmenter(**SEG, impl="reference")
    b = {k: jnp.asarray(v) for k, v in seg_batch().items()}
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), b["points"],
                                       b["features"], b["mask"],
                                       train=False))

    def loss_fn(p, ms, batch, rng, train):
        logits, mut = jm.apply({"params": p, "batch_stats": ms},
                               batch["points"], batch["features"],
                               batch["mask"], train=True,
                               mutable=["batch_stats"])
        loss, acc = jax_seg_loss(logits, batch["label"], batch["mask"])
        return loss, ({"accuracy": acc}, mut["batch_stats"])

    t = jax_trainer.Trainer(loss_fn, variables["params"], JaxOpt(**OPT),
                            donate=False,
                            model_state=variables["batch_stats"])
    metrics = [jax.device_get(t.step(b, jax.random.PRNGKey(2)))
               for _ in range(2)]
    after = {"params": jax.device_get(t.state.params),
             "batch_stats": jax.device_get(t.state.model_state)}
    return (segmenter_state_dict(variables), metrics,
            segmenter_state_dict(after))


@pytest.mark.parametrize("data,space", [(2, 1), (1, 2)], ids=["dp", "sp"])
def test_batch_norm_step_matches_jax_unsharded(tmp_path, data, space):
    init, want, want_state = jax_bn_seg()
    kwargs = dict(SEG, in_features=6,
                  impl="spatial:space" if space > 1 else "auto")
    res = launch.spawn(
        launch.train_worker, data * space, str(tmp_path), data=data,
        space=space, timeout=RUN_LIMIT, device="cpu",
        kwargs=dict(kind="seg", model_kwargs=kwargs, state=init,
                    opt_cfg=OptimizerConfig(**OPT),
                    batches=[seg_batch()] * 2, seeds=[0, 1],
                    space_axis="space" if space > 1 else None))
    for w, g in zip(want, res[0]["metrics"]):
        np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]),
                                   rtol=1e-3)
    stats = [k for k in want_state if "running" in k]
    assert len(stats) == 2
    for k in stats:
        np.testing.assert_allclose(res[0]["state"][k].numpy(),
                                   want_state[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        # the moments are global: every rank keeps the same averages
        for r in res[1:]:
            assert torch.equal(r["state"][k], res[0]["state"][k]), k
        assert not torch.equal(res[0]["state"][k], init[k]), k

