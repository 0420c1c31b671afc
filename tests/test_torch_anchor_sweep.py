"""``python -m pointwise_torch.tools.anchor_sweep`` on the CPU.

The protocol runs ``python -m pointwise_torch.train`` and then ``python -m
pointwise_torch.eval`` per seed, each in its own process (a file of its
own: those processes take most of a minute).  At ``cls_tiny``, 2 seeds x 2
steps: the per-seed records and the summary's mean, min and per-seed
values, and the seeds give different models.
"""

import json

import pytest
import torch

from pointwise_torch.tools import anchor_sweep


def test_anchor_sweep_on_the_cpu(capsys, monkeypatch):
    # one thread per process: the test workers share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    summary = anchor_sweep.main(["--config", "cls_tiny", "--steps", "2",
                                 "--seeds", "0", "1", "--votes", "2",
                                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    seeds = [json.loads(ln.split(": ", 1)[1]) for ln in out
             if ln.startswith("# seed ")]
    assert [r["seed"] for r in seeds] == [0, 1]
    assert all(r["metric"] == "classification_accuracy" and r["votes"] == 2
               for r in seeds)
    assert json.loads(out[-1]) == summary
    vals = [r["value"] for r in seeds]
    assert summary["value_per_seed"] == vals
    assert summary["value_mean"] == pytest.approx(sum(vals) / 2)
    assert summary["value_min"] == min(vals)
    assert all(0.0 <= v <= 1.0 for v in vals)
    assert "seed_mean" not in summary and "n_mean" not in summary


def test_anchor_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        anchor_sweep.main(["--config", "cls_tiny", "--steps", "1",
                           "--seeds", "0"])
