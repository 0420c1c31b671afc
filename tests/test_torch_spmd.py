"""Training over a (data x space) mesh: the port against the JAX package.

The JAX side runs in this process: the JAX package's unsharded ``Trainer``
with a dense-reference model (as tests/test_parallel.py does), from a flax
init that convert.py carries into the port.  The port's side runs its
sums-contract ``Trainer`` on ranks spawned by
``pointwise_torch.parallel.launch`` (gloo, a FileStore in ``tmp_path``, one
torch thread each, every collective bounded by 60 s and each run by its own
limit), each rank on its shard of the same global batch.

Tolerances are those of tests/test_parallel.py (its f32 SPMD pins): loss
and accuracy rtol 1e-5, parameters after one AdamW step rtol 2e-5 and atol
2e-6.  Dropout is 0, so the sharded and unsharded steps compute the same
function.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.models import PointwiseClassifier as JaxClassifier
from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.models import classification_loss as jax_cls_loss
from pointwise_tpu.models import segmentation_loss as jax_seg_loss
from pointwise_tpu.train import trainer as jax_trainer
from pointwise_tpu.train.configs import OptimizerConfig as JaxOpt
from pointwise_torch.convert import classifier_state_dict, segmenter_state_dict
from pointwise_torch.parallel import init_distributed, launch
from pointwise_torch.train.configs import OptimizerConfig

RUN_LIMIT = 240       # seconds for one spawned run, start to end
SEG = dict(num_classes=3, channels=(8,), radii=(0.5,), head_dims=(8,),
           dropout_rate=0.0, precision="float32")
CLS = dict(num_classes=4, channels=(8,), radii=(0.6,), head_dims=(16,),
           dropout_rate=0.0, precision="float32")
OPT = dict(warmup_steps=1, decay_steps=10)


def seg_batch(seed=0, B=8, N=64):
    rng = np.random.RandomState(seed)
    return {"points": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            "features": rng.standard_normal((B, N, 6)).astype(np.float32),
            "label": rng.randint(0, 3, (B, N)).astype(np.int64),
            "mask": (rng.rand(B, N) > 0.2).astype(np.float32)}


def cls_batch(seed=0, B=8, N=64):
    rng = np.random.RandomState(seed)
    return {"points": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            "label": (np.arange(B) % 4).astype(np.int64)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_seg(global_context):
    """(torch state_dict of the init, JAX metrics of one step, torch
    state_dict after it, JAX eval metrics) for the unsharded segmenter."""
    jm = JaxSegmenter(**SEG, impl="reference",
                      use_global_context=global_context)
    b = _jax(seg_batch())
    params = jm.init(jax.random.PRNGKey(1), b["points"], b["features"],
                     b["mask"], train=False)["params"]

    def loss_fn(p, batch, rng, train):
        logits = jm.apply({"params": p}, batch["points"], batch["features"],
                          batch["mask"], train=False)
        loss, acc = jax_seg_loss(logits, batch["label"], batch["mask"])
        return loss, {"accuracy": acc}

    init = segmenter_state_dict({"params": jax.device_get(params)})
    t = jax_trainer.Trainer(loss_fn, params, JaxOpt(**OPT), donate=False)
    m = jax.device_get(t.step(b, jax.random.PRNGKey(2)))
    ev = t.evaluate([b], jax.random.PRNGKey(3))
    return init, m, segmenter_state_dict(
        {"params": jax.device_get(t.state.params)}), ev


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


def _same_on_every_rank(res):
    for r in res[1:]:
        for k, v in res[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k


@pytest.mark.parametrize("global_context", [False, True],
                         ids=["local", "context"])
@pytest.mark.parametrize("data,space", [(2, 2), (1, 2)])
def test_spmd_seg_step_matches_jax_unsharded(tmp_path, data, space,
                                             global_context):
    init, want, want_state, want_ev = jax_seg(global_context)
    kwargs = dict(SEG, in_features=6, impl="spatial:space",
                  use_global_context=global_context,
                  context_axes=("space",) if global_context else ())
    res = launch.spawn(
        launch.train_worker, data * space, str(tmp_path), data=data,
        space=space, timeout=RUN_LIMIT, device="cpu",
        kwargs=dict(kind="seg", model_kwargs=kwargs, state=init,
                    opt_cfg=OptimizerConfig(**OPT), batches=[seg_batch()],
                    seeds=[0], space_axis="space",
                    eval_batches=[seg_batch()]))
    got = res[0]["metrics"][0]
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], float(want["accuracy"]),
                               rtol=1e-5)
    assert all(r["metrics"] == res[0]["metrics"] for r in res)
    _same_on_every_rank(res)
    _assert_state(res[0]["state"], want_state)
    np.testing.assert_allclose(res[0]["eval"]["accuracy"],
                               want_ev["accuracy"], rtol=1e-5)


def _jax_classifier():
    jm = JaxClassifier(**CLS, impl="reference")
    b = _jax(cls_batch())
    params = jm.init(jax.random.PRNGKey(1), b["points"], train=False)["params"]

    def loss_fn(p, batch, rng, train):
        loss, acc = jax_cls_loss(jm.apply({"params": p}, batch["points"],
                                          train=False), batch["label"])
        return loss, {"accuracy": acc}

    init = classifier_state_dict({"params": jax.device_get(params)})
    t = jax_trainer.Trainer(loss_fn, params, JaxOpt(**OPT), donate=False)
    m = jax.device_get(t.step(b, jax.random.PRNGKey(2)))
    return init, m, classifier_state_dict(
        {"params": jax.device_get(t.state.params)})


@pytest.mark.parametrize("data,space,impl", [
    (2, 1, "auto"), (1, 2, "spatial:space:ring")], ids=["dp", "space_ring"])
def test_spmd_classifier_matches_jax_unsharded(tmp_path, data, space, impl):
    # --dp's contract (data 2), and a classifier built with space shards:
    # ring convs and the pooled head reduced over the space group
    init, want, want_state = _jax_classifier()
    kwargs = dict(CLS, impl=impl,
                  context_axes=("space",) if space > 1 else ())
    res = launch.spawn(
        launch.train_worker, data * space, str(tmp_path), data=data,
        space=space, timeout=RUN_LIMIT, device="cpu",
        kwargs=dict(kind="cls", model_kwargs=kwargs, state=init,
                    opt_cfg=OptimizerConfig(**OPT), batches=[cls_batch()],
                    seeds=[0], space_axis="space" if space > 1 else None,
                    rng_axes=("data",)))
    np.testing.assert_allclose(res[0]["metrics"][0]["loss"],
                               float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(res[0]["metrics"][0]["grad_norm"],
                               float(want["grad_norm"]), rtol=1e-4)
    _same_on_every_rank(res)
    _assert_state(res[0]["state"], want_state)


def test_spmd_checkpoint_resume_same_bits(tmp_path):
    # three steps straight == two steps, a checkpoint, a fresh set of ranks
    # that restores it, and the third step
    init, *_ = jax_seg(False)
    kwargs = dict(SEG, in_features=6, impl="spatial:space:ring",
                  use_global_context=False)
    batches = [seg_batch(s) for s in range(3)]
    common = dict(kind="seg", model_kwargs=kwargs, state=init,
                  opt_cfg=OptimizerConfig(**OPT), space_axis="space",
                  checkpoint_dir=str(tmp_path / "ck"))
    full = launch.spawn(launch.train_worker, 4, str(tmp_path / "a"), data=2,
                        space=2, timeout=RUN_LIMIT, device="cpu",
                        kwargs=dict(common, batches=batches, seeds=[0, 1, 2],
                                    save_after=2))
    resumed = launch.spawn(launch.train_worker, 4, str(tmp_path / "b"),
                           data=2, space=2, timeout=RUN_LIMIT, device="cpu",
                           kwargs=dict(common, batches=batches[2:],
                                       seeds=[2], restore=True))
    assert resumed[0]["step"] == full[0]["step"] == 3
    assert resumed[0]["restored_extra"] == {"seed": 1}
    assert resumed[0]["metrics"] == full[0]["metrics"][2:]
    for k, v in full[0]["state"].items():
        assert torch.equal(v, resumed[0]["state"][k]), k
    _same_on_every_rank(resumed)


@pytest.mark.parametrize("argv,data,space", [
    (["--config", "seg_tiny_local", "--sp", "2"], 1, 2),
    (["--config", "seg_tiny_local", "--dp"], 2, 1),
    (["--config", "cls_tiny", "--dp"], 2, 1)],
    ids=["seg_sp", "seg_dp", "cls_dp"])
def test_train_cli_dp_and_sp(tmp_path, argv, data, space):
    res = launch.spawn(
        launch.cli_worker, data * space, str(tmp_path), data=data,
        space=space, timeout=RUN_LIMIT, device="cpu",
        kwargs=dict(argv=argv + ["--steps", "2", "--device", "cpu"]))
    for r in res:
        assert r["step"] == 2 and len(r["metrics"]) == 2
        for m in r["metrics"]:
            assert math.isfinite(m["loss"]) and m["grad_norm"] > 0
            assert 0.0 <= m["accuracy"] <= 1.0
    assert all(r["metrics"] == res[0]["metrics"] for r in res)
    _same_on_every_rank(res)


def test_launch_rules_without_a_launcher(monkeypatch):
    # no torchrun environment: joining is a no-op; a torchrun launch with
    # more local ranks than cards is refused before it touches a card
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("gloo") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="needs a card of its own"):
        launch.rank_device("cuda")


def test_mesh_defaults_to_the_card(monkeypatch):
    # the port's rule: with no device the mesh (and the backend a launch
    # joins with) is the card's, and without one they raise and name the
    # CPU option instead of falling back to gloo on the CPU
    import torch.distributed as dist

    from pointwise_torch.parallel import make_mesh
    from pointwise_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                 ("MASTER_ADDR", "localhost")):
        monkeypatch.setenv(k, v)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    assert not dist.is_initialized()
    # a joined one-rank group, as far as make_mesh looks before it builds
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda group=None: 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(space=1, backend="gloo")


def test_spawn_defaults_to_the_card(monkeypatch, tmp_path):
    # spawned ranks follow the same rule: with no device they run on the
    # card, and without one the launch raises, names the CPU option and
    # starts no process
    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch.mp, "get_context",
                        lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.spawn(launch.conv_worker, 2, str(tmp_path / "ranks"))
    assert not started and not (tmp_path / "ranks").exists()
