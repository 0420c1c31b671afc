"""Checkpoints of the JAX trainer read, served and scored by the port.

The JAX ``Trainer`` takes two steps of a tiny net and writes an orbax
checkpoint after each (``save_checkpoint``, with the loop's extra state as
train.py saves it): a LayerNorm segmenter and a BatchNorm one at
seg_tiny_stream's widths (so its running averages moved), a classifier at
cls_tiny's widths and a 10-way head (the synthetic data's classes), and a
part segmenter at shapenetpart_tiny's.  ``convert.read_jax_checkpoint``
gives the trainer's arrays exactly; the port's eval-mode logits from them
(f32 convs) equal the JAX model's within 2e-4, the tolerance of
test_torch_segmenter.py's JAX comparisons, through ``read_jax_checkpoint``
and a convert.py loader, through ``infer.load_trained`` and through the
export tool's ``.npz`` and ``--params``.  ``infer`` and ``eval
--checkpoint-dir`` run on the orbax directory and report the restored
step; an uncommitted step and orbax's temporary directories are skipped;
``--step`` picks an older step; without ``tensorstore`` the error names the
export tool; ``train --resume`` refuses a JAX run.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_torch import convert
from pointwise_torch import eval as port_eval
from pointwise_torch import infer
from pointwise_torch.models import (PointwiseClassifier, PointwiseSegmenter,
                                    ShapeNetPartSegmenter)
from pointwise_torch.tools import export_checkpoint
from pointwise_torch.train import cli as train_cli
from pointwise_tpu.models import PointwiseClassifier as JaxClassifier
from pointwise_tpu.models import PointwiseSegmenter as JaxSegmenter
from pointwise_tpu.models import ShapeNetPartSegmenter as JaxPartSegmenter
from pointwise_tpu.models import classification_loss as jax_cls_loss
from pointwise_tpu.models import segmentation_loss as jax_seg_loss
from pointwise_tpu.train import trainer as jax_trainer
from pointwise_tpu.train.configs import OptimizerConfig

TOL = 2e-4
OPT = OptimizerConfig(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
SEG = dict(num_classes=5, channels=(8, 8), radii=(0.25, 0.5),
           head_dims=(16,), dropout_rate=0.0)
CLS = dict(num_classes=10, channels=(8, 8), radii=(0.5, 1.0),
           head_dims=(16,), dropout_rate=0.0)
PART = dict(num_parts=48, num_categories=16, channels=(8, 8),
            radii=(0.3, 0.5), head_dims=(16,), dropout_rate=0.0)
KINDS = ("seg_layer", "seg_batch", "cls", "partseg")
LOADERS = {"seg_layer": convert.load_segmenter,
           "seg_batch": convert.load_segmenter,
           "cls": convert.load_classifier,
           "partseg": convert.load_shapenetpart}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind):
    rng = np.random.RandomState(7)
    if kind == "cls":
        return {"points": rng.uniform(-1, 1, (3, 64, 3)).astype(np.float32),
                "label": np.array([0, 3, 9], np.int32)}
    if kind == "partseg":
        return {"points": rng.uniform(-1, 1, (2, 96, 3)).astype(np.float32),
                "category": np.array([1, 5], np.int32),
                "mask": (rng.rand(2, 96) > 0.2).astype(np.float32),
                "label": rng.randint(0, 48, (2, 96)).astype(np.int32)}
    return {"points": rng.uniform(0, 1.2, (2, 128, 3)).astype(np.float32),
            "features": rng.uniform(0, 1, (2, 128, 6)).astype(np.float32),
            "mask": (rng.rand(2, 128) > 0.2).astype(np.float32),
            "label": rng.randint(0, 5, (2, 128)).astype(np.int32)}


def _jax_model(kind):
    if kind == "cls":
        return JaxClassifier(**CLS, impl="reference", precision="float32")
    if kind == "partseg":
        return JaxPartSegmenter(**PART, impl="reference",
                                precision="float32")
    return JaxSegmenter(**SEG, norm="batch" if kind == "seg_batch"
                        else "layer", impl="reference", precision="float32",
                        use_global_context=False)


def _port_model(kind):
    if kind == "cls":
        return PointwiseClassifier(**CLS, precision="float32")
    if kind == "partseg":
        return ShapeNetPartSegmenter(**PART, precision="float32")
    return PointwiseSegmenter(in_features=6, **SEG, precision="float32",
                              norm="batch" if kind == "seg_batch"
                              else "layer", use_global_context=False)


def _apply_args(kind, b):
    if kind == "cls":
        return (b["points"],), {}
    if kind == "partseg":
        return (b["points"], b["category"]), {"mask": b["mask"]}
    return (b["points"], b["features"], b["mask"]), {}


def _jax_loss(kind, jm):
    def logits(variables, b, train, mutable=False):
        args, kw = _apply_args(kind, b)
        return jm.apply(variables, *args, train=train, **kw,
                        **({"mutable": ["batch_stats"]} if mutable else {}))

    if kind == "seg_batch":
        def loss_fn(p, ms, b, rng, train):
            y, mut = logits({"params": p, "batch_stats": ms}, b, train, True)
            loss, acc = jax_seg_loss(y, b["label"], b["mask"])
            return loss, ({"accuracy": acc}, mut["batch_stats"])
        return loss_fn

    def loss_fn(p, b, rng, train):
        y = logits({"params": p}, b, train)
        if kind == "cls":
            loss, acc = jax_cls_loss(y, b["label"])
        else:
            loss, acc = jax_seg_loss(y, b["label"], b["mask"])
        return loss, {"accuracy": acc}
    return loss_fn


def _write_run(kind, directory):
    """Two JAX trainer steps, a checkpoint after each; returns the JAX
    model, its initial and final variables (numpy) and the step-1
    variables."""
    jm = _jax_model(kind)
    b = {k: jnp.asarray(v) for k, v in _inputs(kind).items()}
    args, kw = _apply_args(kind, b)
    init = jax.device_get(jm.init(jax.random.PRNGKey(0), *args, **kw))
    jt = jax_trainer.Trainer(_jax_loss(kind, jm), init["params"], OPT,
                             donate=False,
                             model_state=init.get("batch_stats"))
    snaps = []
    for step in range(2):
        jt.step(b, jax.random.PRNGKey(step))
        jt.save_checkpoint(directory,
                           extra={"rng_base": np.array([0, 3], np.uint32)})
        state = {"params": jax.device_get(jt.state.params)}
        if jt.state.model_state is not None:
            state["batch_stats"] = jax.device_get(jt.state.model_state)
        snaps.append(state)
    return jm, init, snaps[1], snaps[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_runs")
    return {kind: (os.fspath(root / kind), *_write_run(kind,
                                                       root / kind))
            for kind in KINDS}


def _jax_logits(kind, jm, variables):
    args, kw = _apply_args(kind, _inputs(kind))
    return np.asarray(jm.apply(variables, *args, train=False, **kw))


def _logits(kind, model):
    args, kw = _apply_args(kind, {k: torch.from_numpy(v)
                                  for k, v in _inputs(kind).items()})
    with torch.no_grad():
        return model.eval()(*args, **kw).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_reads_into_the_jax_models_logits(kind, runs):
    d, jm, init, final, _ = runs[kind]
    step, variables = convert.read_jax_checkpoint(d)
    assert step == 2
    want = convert.flatten(final)
    assert sorted(variables) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(variables[k], v, err_msg=k)
    # two steps moved the weights (and BatchNorm's running averages)
    moved = [k for k, v in convert.flatten(init).items()
             if not np.array_equal(v, want[k])]
    assert any(k.startswith("params/") for k in moved)
    if kind == "seg_batch":
        assert any(k.startswith("batch_stats/") for k in moved)
    jax_logits = _jax_logits(kind, jm, final)
    model = _port_model(kind)
    LOADERS[kind](model, variables)
    np.testing.assert_allclose(_logits(kind, model), jax_logits, rtol=TOL,
                               atol=TOL)
    model = _port_model(kind)
    assert infer.load_trained(model, d, LOADERS[kind]) == 2
    np.testing.assert_allclose(_logits(kind, model), jax_logits, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_exported_npz_gives_the_same_logits(kind, runs, tmp_path, capsys):
    d, jm, _, final, _ = runs[kind]
    out = os.fspath(tmp_path / "w.npz")
    rec = export_checkpoint.main([d, out])
    assert rec == {"step": 2, "out": out,
                   "arrays": len(convert.flatten(final))}
    assert json.loads(capsys.readouterr().out.strip()) == rec
    with np.load(out) as z:
        assert all(k.startswith(("params/", "batch_stats/"))
                   for k in z.files)
    via_params, via_dir = _port_model(kind), _port_model(kind)
    assert infer.load_weights(via_params, LOADERS[kind],
                              params_path=out) == f"loaded {out}"
    assert infer.load_weights(via_dir, LOADERS[kind], checkpoint_dir=d) == (
        f"restored step 2 from {d}")
    got = _logits(kind, via_params)
    np.testing.assert_array_equal(got, _logits(kind, via_dir))
    np.testing.assert_allclose(got, _jax_logits(kind, jm, final), rtol=TOL,
                               atol=TOL)


def test_uncommitted_steps_are_skipped_and_step_picks_older(runs, tmp_path,
                                                            capsys):
    d, jm, _, final, first = runs["seg_layer"]
    d2 = tmp_path / "run"
    shutil.copytree(d, d2)
    (d2 / "100").mkdir()                           # never committed
    shutil.copytree(d2 / "2", d2 / "7.orbax-checkpoint-tmp-1792")
    (d2 / "7.orbax-checkpoint-tmp-1792" / "_CHECKPOINT_METADATA").unlink()
    assert convert.jax_checkpoint_steps(d2) == [1, 2]
    step, variables = convert.read_jax_checkpoint(d2)
    assert step == 2
    np.testing.assert_array_equal(variables["params/Dense_0/kernel"],
                                  final["params"]["Dense_0"]["kernel"])
    step, variables = convert.read_jax_checkpoint(d2, step=1)
    assert step == 1
    for k, v in convert.flatten(first).items():
        np.testing.assert_array_equal(variables[k], v, err_msg=k)
    rec = export_checkpoint.main([os.fspath(d2), os.fspath(tmp_path / "1.npz"),
                                  "--step", "1"])
    assert rec["step"] == 1
    with pytest.raises(FileNotFoundError, match="orbax.*step 100"):
        convert.read_jax_checkpoint(d2, step=100)
    # a directory whose only numbered step never committed
    lone = tmp_path / "lone"
    (lone / "100").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match=f"{lone}.*orbax"):
        infer.load_trained(_port_model("seg_layer"), os.fspath(lone),
                           convert.load_segmenter)


@pytest.mark.parametrize("kind", ["seg_layer", "seg_batch"])
def test_infer_serves_a_jax_checkpoint(kind, runs, tmp_path, capsys):
    d = runs[kind][0]
    rng = np.random.RandomState(2)
    n = 300
    (tmp_path / "rooms").mkdir()
    np.save(tmp_path / "rooms" / "a.npy", np.concatenate(
        [rng.uniform(0.0, 1.5, (n, 3)), rng.uniform(0.0, 1.0, (n, 3)),
         rng.randint(0, 5, (n, 1))], axis=1).astype(np.float32))
    norm = ["--norm", "batch"] if kind == "seg_batch" else []
    infer.main(["--config", "seg_tiny_stream", "--device", "cpu",
                "--checkpoint-dir", d, "--data-dir",
                os.fspath(tmp_path / "rooms"), "--tile-size", "1.5"] + norm)
    out = capsys.readouterr().out
    assert f"# restored step 2 from {d}" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["n_points"] == n and rec["value"] > 0


@pytest.mark.parametrize("kind,config", [("cls", "cls_tiny"),
                                         ("partseg", "shapenetpart_tiny")])
def test_eval_scores_a_jax_checkpoint(kind, config, runs, capsys):
    d = runs[kind][0]
    port_eval.main(["--config", config, "--device", "cpu",
                    "--checkpoint-dir", d])
    out = capsys.readouterr().out
    assert f"# restored step 2 from {d}" in out
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    key = "value" if kind == "cls" else "instance_miou"
    assert 0.0 <= rec[key] <= 1.0


def test_without_tensorstore_the_error_names_the_export_tool(runs,
                                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore.*export_checkpoint"):
        convert.read_jax_checkpoint(runs["cls"][0])


def test_train_resume_refuses_a_jax_run(runs, tmp_path):
    d = tmp_path / "run"
    shutil.copytree(runs["cls"][0], d)
    before = sorted(os.listdir(d))
    with pytest.raises(ValueError, match="optimizer state and PRNG keys"):
        train_cli.main(["--config", "cls_tiny", "--steps", "1", "--device",
                        "cpu", "--checkpoint-dir", os.fspath(d),
                        "--resume"])
    assert sorted(os.listdir(d)) == before
