"""The port's eval CLI (``python -m pointwise_torch.eval``) held against the
JAX package's eval.py on the CPU.

Each flow runs in this process twice on the same weights: eval.py's
function with its fresh init (``PRNGKey(0)``), and the port's ``main`` with
that init flattened to an ``.npz`` (``--params``).  Both sides record the
predictions their metric functions receive; they may differ in at most one
sample or point (a near-tie argmax that the port's bf16 kernels flip), and
the printed JSON lines must carry the same metric names and keys, with the
values equal when the predictions are.  The segmentation flows are in
test_torch_eval_scenes.py, which imports the helpers here.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import pointwise_tpu.data.shapenetpart as jax_shapenetpart
import pointwise_tpu.utils.metrics as jax_metrics
from pointwise_torch import eval as port_eval
from pointwise_torch.convert import flatten
from pointwise_tpu.train import get_config as jax_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_eval():
    """The repo root's eval.py (the JAX CLI) as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_cli", os.path.join(REPO, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Args:
    """eval.py's parsed arguments, its defaults unless given."""

    def __init__(self, **kw):
        self.data_dir = self.checkpoint_dir = self.params = None
        self.votes, self.stride, self.streaming = 1, None, False
        self.__dict__.update(kw)


def record(monkeypatch, module, name, calls):
    """Wrap ``module.name`` so each call's first argument (the predictions)
    lands in ``calls``."""
    orig = getattr(module, name)

    def wrapped(pred, *a, **k):
        calls.append(np.array(pred))
        return orig(pred, *a, **k)

    monkeypatch.setattr(module, name, wrapped)


def json_line(out):
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(recs) == 1, out
    return recs[0]


def run_both(jax_eval, monkeypatch, capsys, tmp_path, jax_fn, cfg,
             jax_args, argv, metric_fn):
    """eval.py's ``jax_fn(cfg, jax_args)`` and the port's ``main(argv)`` on
    its weights; returns (JAX line, port line, JAX predictions, port
    predictions)."""
    captured = {}
    orig = jax_eval._restore_variables

    def keep(*a, **k):
        captured["v"] = orig(*a, **k)
        return captured["v"]

    monkeypatch.setattr(jax_eval, "_restore_variables", keep)
    jax_preds, port_preds = [], []
    module, name = metric_fn
    record(monkeypatch, module[0], name, jax_preds)
    jax_fn(cfg, jax_args)
    want = json_line(capsys.readouterr().out)
    params = tmp_path / "w.npz"
    np.savez(params, **flatten(jax.device_get(captured["v"])))
    record(monkeypatch, module[1], name, port_preds)
    port_eval.main(argv + ["--params", os.fspath(params), "--device", "cpu"])
    got = json_line(capsys.readouterr().out)
    return want, got, jax_preds[-1], port_preds[-1]


def write_rooms(path, n_rooms=2, n=300):
    """``n_rooms`` rooms of ``n`` random points (xyz, rgb, 5 labels)."""
    rng = np.random.RandomState(3)
    for i in range(n_rooms):
        xyz = rng.uniform(0.0, 1.5, (n, 3)).astype(np.float32)
        rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        lab = rng.randint(0, 5, (n, 1)).astype(np.float32)
        np.save(path / f"room{i}.npy", np.concatenate([xyz, rgb, lab], 1))


def agree(want, got, pj, pt, keys):
    assert sorted(got) == sorted(want)
    assert got["metric"] == want["metric"]
    assert pj.shape == pt.shape
    assert int((pj != pt).sum()) <= 1
    if (pj == pt).all():
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    for k in set(want) - set(keys) - {"metric"}:
        assert got[k] == want[k], k


def test_classification_voting_matches_jax(jax_eval, monkeypatch, capsys,
                                           tmp_path):
    cfg = jax_config("cls_tiny")
    want, got, pj, pt = run_both(
        jax_eval, monkeypatch, capsys, tmp_path, jax_eval.eval_classification,
        cfg, Args(votes=2), ["--config", "cls_tiny", "--votes", "2"],
        ((jax_metrics, port_eval), "segmentation_metrics"))
    assert want["votes"] == 2 and want["n"] == 256
    agree(want, got, pj, pt, ("value", "mean_class_accuracy"))
    assert abs(got["value"] - want["value"]) <= 1 / want["n"]


def test_shapenetpart_matches_jax(jax_eval, monkeypatch, capsys, tmp_path):
    want, got, pj, pt = run_both(
        jax_eval, monkeypatch, capsys, tmp_path, jax_eval.eval_shapenetpart,
        jax_config("shapenetpart_tiny"), Args(),
        ["--config", "shapenetpart_tiny"],
        ((jax_shapenetpart, port_eval.shapenetpart), "category_miou"))
    assert want["n"] == 64 and pj.shape == (64, 128)
    agree(want, got, pj, pt, ("accuracy", "instance_miou"))


def test_checkpoint_of_the_train_cli_evaluates(tmp_path, capsys):
    # a --norm batch checkpoint of the port's trainer evaluates with its
    # running averages; an orbax directory is refused; both sources at once
    # are refused
    from pointwise_torch.train.cli import main as train

    ck = os.fspath(tmp_path / "ck")
    data = tmp_path / "data"
    data.mkdir()
    write_rooms(data)
    common = ["--config", "seg_tiny_stream", "--norm", "batch",
              "--data-dir", os.fspath(data), "--device", "cpu"]
    train(common + ["--steps", "2", "--checkpoint-dir", ck])
    capsys.readouterr()
    port_eval.main(common + ["--checkpoint-dir", ck])
    out = capsys.readouterr().out
    assert "# restored step 2" in out
    rec = json_line(out)
    assert rec["metric"] == "segmentation" and 0 <= rec["accuracy"] <= 1
    orbax = tmp_path / "orbax"
    (orbax / "100").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        port_eval.main(["--config", "seg_tiny_stream", "--device", "cpu",
                        "--checkpoint-dir", os.fspath(orbax)])
    with pytest.raises(ValueError, match="not both"):
        port_eval.main(["--config", "cls_tiny", "--device", "cpu",
                        "--checkpoint-dir", ck, "--params", "w.npz"])


def test_streaming_refuses_global_context(capsys):
    with pytest.raises(SystemExit, match="locality-only.*_local"):
        port_eval.main(["--config", "s3dis_synthetic", "--streaming",
                        "--device", "cpu"])


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(["--config", "cls_tiny"])
