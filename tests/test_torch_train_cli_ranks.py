"""The train CLI over 2 spawned gloo ranks (``launch.cli_worker``): the
options this slice opened, ``--dp --norm batch``, ``--sp 2 --norm batch``
and ShapeNetPart under ``--dp``.  Every rank ends each step on the same
metrics and the run on the same bits; the steps themselves are held against
the JAX package in tests/test_torch_spmd_batchnorm.py and
tests/test_torch_spmd_partseg.py."""

import math

import pytest
import torch

from pointwise_torch.parallel import launch

RUN_LIMIT = 240       # seconds for one spawned run, start to end


@pytest.mark.parametrize("argv,data,space", [
    (["--config", "seg_tiny_local", "--dp", "--norm", "batch"], 2, 1),
    (["--config", "seg_tiny_local", "--sp", "2", "--norm", "batch"], 1, 2),
    (["--config", "shapenetpart_tiny", "--dp"], 2, 1)],
    ids=["seg_dp_bn", "seg_sp_bn", "partseg_dp"])
def test_train_cli_batch_norm_and_partseg_over_ranks(tmp_path, argv, data,
                                                     space):
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
    for r in res[1:]:
        for k, v in res[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
