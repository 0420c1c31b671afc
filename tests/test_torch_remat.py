"""Rematerialised training (``remat=True``) of the port's three nets.

``remat=True`` recomputes each trunk block in the backward
(``torch.utils.checkpoint``).  It must change nothing a training step
computes: on the CPU (the plain versions of the kernels) one AdamW step
with and without it gives the same bits of loss, gradients, parameters and
BatchNorm running averages, the same dropout masks and the same random
state after the step, while the forward kernels run twice.  Against the
JAX nets with ``remat=True`` (through convert.py, the JAX op through its
dense reference) the gradients agree at tests/test_torch_grad.py's f32
tolerance: rtol 1e-4 and atol 1e-4 x max |want|.  Under a 2-rank gloo mesh
the ring strategy's step with remat (its collectives issued again inside
the backward) equals the step without, bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_torch.convert import (classifier_state_dict,
                                     segmenter_state_dict,
                                     shapenetpart_state_dict)
from pointwise_torch.models import (PointwiseClassifier, PointwiseSegmenter,
                                    ShapeNetPartSegmenter,
                                    classification_loss, segmentation_loss)
from pointwise_torch.models import layers
from pointwise_torch.parallel import launch
from pointwise_torch.train.configs import OptimizerConfig
from pointwise_torch.train.trainer import Trainer
from pointwise_tpu.models import PointwiseClassifier as JaxClassifier
from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.models import ShapeNetPartSegmenter as JaxPartSegmenter
from pointwise_tpu.models import classification_loss as jax_cls_loss
from pointwise_tpu.models import segmentation_loss as jax_seg_loss

OPT = OptimizerConfig(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
NETS = {
    "seg": (PointwiseSegmenter,
            dict(num_classes=3, in_features=6, channels=(8, 8),
                 radii=(0.3, 0.6), head_dims=(8,))),
    "partseg": (ShapeNetPartSegmenter,
                dict(num_parts=6, num_categories=4, channels=(8, 8),
                     radii=(0.3, 0.6), head_dims=(8,))),
    "cls": (PointwiseClassifier,
            dict(num_classes=4, channels=(8, 8), radii=(0.4, 0.8),
                 head_dims=(8,))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(net, seed=0, b=2, n=96):
    rng = np.random.RandomState(seed)
    out = {"points": rng.uniform(-1, 1, (b, n, 3)).astype(np.float32),
           "mask": (rng.rand(b, n) > 0.2).astype(np.float32)}
    if net == "seg":
        out["features"] = rng.standard_normal((b, n, 6)).astype(np.float32)
        out["label"] = rng.randint(0, 3, (b, n)).astype(np.int64)
    elif net == "partseg":
        out["category"] = rng.randint(0, 4, b).astype(np.int64)
        out["label"] = rng.randint(0, 6, (b, n)).astype(np.int64)
    else:
        out["label"] = (np.arange(b) % 4).astype(np.int64)
    return out


def _logits(net, model, b):
    if net == "seg":
        return model(b["points"], b["features"], b["mask"])
    if net == "partseg":
        return model(b["points"], b["category"], mask=b["mask"])
    return model(b["points"], mask=b["mask"])


def _loss(net):
    def loss_fn(model, b, generator, train):
        logits = _logits(net, model, b)
        if net == "cls":
            loss, acc = classification_loss(logits, b["label"])
        else:
            loss, acc = segmentation_loss(logits, b["label"], b["mask"])
        return loss, {"accuracy": acc}
    return loss_fn


def _model(net, remat, **kw):
    cls, base = NETS[net]
    return cls(**dict(base, **kw), remat=remat, precision="float32",
               generator=torch.Generator().manual_seed(0))


def _count_forwards(monkeypatch):
    """The number of forward kernel calls (the op layer's means walk,
    ``conv_fwd_means``)."""
    op = importlib.import_module("pointwise_torch.ops.pointwise_conv")
    calls = [0]
    orig = op.conv_fwd_means

    def counting(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(op, "conv_fwd_means", counting)
    return calls


@pytest.mark.parametrize("norm", ["layer", "batch"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_remat_step_is_bitwise_equal(net, norm, monkeypatch):
    calls = _count_forwards(monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(net).items()}
    runs = {}
    for remat in (False, True):
        calls[0] = 0
        model = _model(net, remat, norm=norm, dropout_rate=0.3)
        trainer = Trainer(model, _loss(net), OPT)
        metrics = trainer.step(batch, seed=5)
        runs[remat] = (metrics, model, calls[0])
    (m0, a, n0), (m1, b, n1) = runs[False], runs[True]
    assert sorted(m0) == sorted(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)          # the same checkpoint layout
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa.grad, pb.grad), name
    if norm == "batch":                      # moved once, not twice
        stats = [k for k in sa if k.endswith("running_mean")]
        assert len(stats) == 2
        assert not torch.equal(sa[stats[0]], torch.zeros_like(sa[stats[0]]))
    blocks = len(NETS[net][1]["channels"])
    assert n0 == blocks and n1 == 2 * blocks   # recomputed in the backward


def test_dropout_masks_are_unchanged_by_remat():
    batch = {k: torch.from_numpy(v) for k, v in _batch("seg").items()}
    out = {}
    for remat, seed in ((False, 11), (True, 11), ("other seed", 12)):
        model = _model("seg", remat is True, dropout_rate=0.5).train()
        torch.manual_seed(seed)
        logits = _logits("seg", model, batch)
        (logits ** 2).sum().backward()
        out[remat] = (logits.detach(), torch.get_rng_state(),
                      [p.grad for p in model.parameters()])
    assert torch.equal(out[False][0], out[True][0])
    # the masks matter: another seed draws other ones
    assert not torch.equal(out[False][0], out["other seed"][0])
    assert torch.equal(out[False][1], out[True][1])
    for ga, gb in zip(out[False][2], out[True][2]):
        assert torch.equal(ga, gb)


def test_serving_and_eval_do_not_rematerialise(monkeypatch):
    used = [0]
    orig = layers.checkpoint

    def counting(*args, **kw):
        used[0] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counting)
    batch = {k: torch.from_numpy(v) for k, v in _batch("seg").items()}
    model = _model("seg", True)
    with torch.no_grad():
        model.train()
        _logits("seg", model, batch)
    model.eval()
    evaluated = _logits("seg", model, batch)
    assert used[0] == 0
    plain = _model("seg", False).eval()
    assert torch.equal(evaluated, _logits("seg", plain, batch))
    model.train()
    _logits("seg", model, batch)
    assert used[0] == 2                       # one per block


def _jax_grads(net, batch):
    """(torch state_dict of a flax init of the JAX net with remat=True, its
    loss, its gradients in the state_dict layout)."""
    _, base = NETS[net]
    kw = {k: v for k, v in base.items() if k != "in_features"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if net == "seg":
        jm = JaxSegmenter(**kw, dropout_rate=0.0, remat=True,
                          impl="reference", precision="float32")
        args = (jb["points"], jb["features"], jb["mask"])
        to_sd = segmenter_state_dict
    elif net == "partseg":
        jm = JaxPartSegmenter(**kw, dropout_rate=0.0, remat=True,
                              impl="reference", precision="float32")
        args = (jb["points"], jb["category"], None, jb["mask"])
        to_sd = shapenetpart_state_dict
    else:
        jm = JaxClassifier(**kw, dropout_rate=0.0, remat=True,
                           impl="reference", precision="float32")
        args = (jb["points"], None, jb["mask"])
        to_sd = classifier_state_dict
    params = jm.init(jax.random.PRNGKey(3), *args, train=False)["params"]

    def loss(p):
        logits = jm.apply({"params": p}, *args, train=True)
        if net == "cls":
            return jax_cls_loss(logits, jb["label"])[0]
        return jax_seg_loss(logits, jb["label"], jb["mask"])[0]

    value, grads = jax.value_and_grad(loss)(params)
    return (to_sd({"params": jax.device_get(params)}), float(value),
            to_sd({"params": jax.device_get(grads)}))


@pytest.mark.parametrize("net", sorted(NETS))
def test_remat_grads_match_jax_remat(net):
    batch = _batch(net)
    init, want_loss, want = _jax_grads(net, batch)
    model = _model(net, True, dropout_rate=0.0)
    model.load_state_dict(init)
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = _loss(net)(model, tb, None, True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_ring_step_with_remat_equals_without(tmp_path):
    # --sp 2 on 2 gloo ranks, the ring strategy, BatchNorm moments summed
    # over both ranks and the global-context pool: the recompute issues the
    # counts gather, the ring's shifts and the moments' all-reduce again
    # inside the backward, in the same order on both ranks
    init = _model("seg", False, norm="batch").state_dict()
    batch = _batch("seg", b=4, n=64)
    res = {}
    for remat in (False, True):
        kwargs = dict(NETS["seg"][1], dropout_rate=0.0, norm="batch",
                      impl="spatial:space:ring", remat=remat,
                      precision="float32", context_axes=("space",))
        res[remat] = launch.spawn(
            launch.train_worker, 2, str(tmp_path / str(remat)), data=1,
            space=2, timeout=240, device="cpu",
            kwargs=dict(kind="seg", model_kwargs=kwargs, state=init,
                        opt_cfg=OPT, batches=[batch, _batch("seg", 1, 4, 64)],
                        seeds=[0, 1], space_axis="space"))
    for a, b in zip(res[False], res[True]):
        assert a["metrics"] == b["metrics"]
        for k, v in a["state"].items():
            assert torch.equal(v, b["state"][k]), k
    assert res[False][0]["metrics"][0]["grad_norm"] > 0
