"""The port's training CLI (``python -m pointwise_torch.train``) on the CPU.

Tiny configs with ``--device cpu`` (the plain versions of the kernels):
finite JSONL metrics, checkpoints that keep the newest k, a resumed run
that ends bitwise equal to an uninterrupted one, and the device rule (no
card: ``--device cuda``, the default, fails instead of falling back).
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from pointwise_torch.train.cli import main
from pointwise_torch.train.trainer import checkpoint_steps, load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CPU paths run many small ops; with the test workers sharing the
    # cores, more intra-op threads only add contention
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def test_cli_segmentation_prints_finite_metrics():
    out = subprocess.run(
        [sys.executable, "-m", "pointwise_torch.train", "--config",
         "seg_tiny_local", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    recs = _records(out.stdout)
    train = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    for r in train:
        assert math.isfinite(r["loss"]) and r["grad_norm"] > 0
        assert 0.0 <= r["accuracy"] <= 1.0
    evals = [r for r in recs if r.get("split") == "heldout_rooms"]
    assert len(evals) == 1 and 0.0 <= evals[0]["accuracy"] <= 1.0


def test_cli_classification_prints_finite_metrics(capsys):
    trainer = main(["--config", "cls_tiny", "--steps", "3", "--device",
                    "cpu"])
    assert trainer.step_count == 3
    recs = _records(capsys.readouterr().out)
    train = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(math.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in train)
    assert [r["split"] for r in recs if "split" in r] == ["test"]


@pytest.mark.parametrize("config", ["cls_tiny", "seg_tiny_local"])
def test_resume_is_bitwise_equal(config, tmp_path):
    assert_resumed_run_equal(["--config", config, "--device", "cpu"],
                              tmp_path)


def assert_resumed_run_equal(common, tmp_path):
    """Four steps straight == two steps, a checkpoint, and a resumed run to
    four, bit for bit (the model and the saved checkpoints); returns the
    final state_dict."""
    a, b = os.fspath(tmp_path / "a"), os.fspath(tmp_path / "b")
    full = main(common + ["--steps", "4", "--checkpoint-dir", a])
    main(common + ["--steps", "2", "--checkpoint-dir", b])
    resumed = main(common + ["--steps", "4", "--checkpoint-dir", b,
                             "--resume"])
    assert full.step_count == resumed.step_count == 4
    assert checkpoint_steps(b) == [2, 4]
    want, got = full.model.state_dict(), resumed.model.state_dict()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    sa, sb = load_checkpoint(a), load_checkpoint(b)
    assert sa["step"] == sb["step"] == 4 and sa["extra"] == sb["extra"]
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    return want


def test_checkpoints_keep_newest(tmp_path):
    trainer = main(["--config", "cls_tiny", "--steps", "1", "--device",
                    "cpu"])
    d = os.fspath(tmp_path / "ck")
    for _ in range(4):
        trainer.step_count += 1
        trainer.save_checkpoint(d, keep=2, extra={"seed": 0})
    assert checkpoint_steps(d) == [4, 5]
    assert trainer.restore_checkpoint(d) == 5
    assert trainer.restored_extra == {"seed": 0}
    assert trainer.restore_checkpoint(os.fspath(tmp_path / "none")) == 0


def test_cuda_default_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", "cls_tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", "cls_tiny", "--steps", "1", "--device", "cuda"])


@pytest.mark.parametrize("extra", [["--sp", "2"]], ids=["extra1"])
def test_not_yet_ported_options_fail(extra):
    # --sp shards segmentation only: the JAX package trains no classifier
    # with space shards, so the CLI refuses one as train.py does not build it
    with pytest.raises(ValueError, match="trains no classifier with space "
                                         "shards"):
        main(["--config", "cls_tiny", "--steps", "1", "--device", "cpu"]
             + extra)
