"""The port's eval CLI against eval.py on the segmentation flows: block
voting and exact streaming on S3DIS-style rooms, block voting on SceneNN
scenes (see test_torch_eval.py, whose helpers run both sides)."""

import os

import numpy as np
import pytest
import torch

import pointwise_tpu.data.s3dis as jax_s3dis
from pointwise_torch import eval as port_eval
from pointwise_tpu.data import synthetic as jax_synthetic
from pointwise_tpu.train import get_config as jax_config
from test_torch_eval import Args, agree, jax_eval, run_both, write_rooms  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_scenes(path, n_scenes=2):
    for i in range(n_scenes):
        xyz, rgb, lab = jax_synthetic.scenenn_scene(
            seed=i, num_objects=4, points_per_obj=60, room=1.5)
        np.save(path / f"scene{i}.npy",
                np.concatenate([xyz, rgb, lab[:, None].astype(np.float32)],
                               1))


@pytest.mark.parametrize("config,streaming", [
    ("seg_tiny_stream", False), ("seg_tiny_stream", True),
    ("scenenn_tiny", False)], ids=["voting", "streaming", "scenenn_voting"])
def test_segmentation_matches_jax(jax_eval, monkeypatch, capsys, tmp_path,
                                  config, streaming):
    data = tmp_path / "data"
    data.mkdir()
    (_write_scenes if config.startswith("scenenn") else write_rooms)(data)
    want, got, pj, pt = run_both(
        jax_eval, monkeypatch, capsys, tmp_path, jax_eval.eval_segmentation,
        jax_config(config), Args(data_dir=os.fspath(data),
                                 streaming=streaming),
        ["--config", config, "--data-dir", os.fspath(data)]
        + (["--streaming"] if streaming else []),
        ((jax_s3dis, port_eval.s3dis), "iou_metrics"))
    assert want["metric"] == ("segmentation_streaming" if streaming
                              else "segmentation")
    assert want["scenes"] == 2
    agree(want, got, pj, pt, ("accuracy", "miou"))
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / len(pj)
