"""The walk-split tool (pointwise_torch/tools/walk_split.py) on the CPU:
it captures each conv layer's largest call of a served request, training
blocks or shapes and runs the plain walk and the plain cull share on it; the instrumented kernel itself builds and runs only
on the card.  The main build never compiles the instrumented source, and
only that source turns the stamps on.  Serving a synthetic room on the
CPU's dense reference takes minutes, so the test's server runs the model
once on a 256-point patch in its place (the hook sees the same convs).
"""

import os

import numpy as np
import pytest
import torch

from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.tools import walk_split


def _patch_serve(args, cfg, model, requests, emit):
    n = int(requests[0].split(":")[1])
    rng = np.random.RandomState(n)
    pts = torch.from_numpy(rng.uniform(0, 1, (1, n, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal(
        (1, n, cfg.in_features)).astype(np.float32))
    with torch.inference_mode():
        model(pts, feats)


def test_walk_split_on_the_cpu(monkeypatch):
    monkeypatch.setattr(walk_split.infer, "serve", _patch_serve)
    recs = walk_split.main(["--device", "cpu", "--config", "seg_tiny_stream",
                            "--points", "256", "192", "--layers", "0", "1"])
    assert [(r["request"], r["layer"]) for r in recs] == [
        ("synth:256", 0), ("synth:256", 1), ("synth:192", 0),
        ("synth:192", 1)]
    assert [r["Mp"] for r in recs] == [256, 256, 192, 192]
    for r, cin in zip(recs, (6, 8)):
        assert r["cin"] == cin and r["card"] == "cpu"
        assert r["pairs"] > 0 and r["tiles_listed"] > 0
        assert r["walk"] == ("csr" if r["csr_by_op"] else "dense")
        for key in ("ms", "instrumented_ms", "cycles", "share", "ksteps"):
            assert r[key] == "not measured"
        assert 0 < r["cull_share"] <= 1


def test_walk_split_on_training_blocks_on_the_cpu():
    recs = walk_split.main(["--device", "cpu", "--config", "seg_tiny_local",
                            "--blocks", "1", "--layers", "0", "1"])
    assert [(r["request"], r["layer"]) for r in recs] == [
        ("blocks:1x256", 0), ("blocks:1x256", 1)]
    assert all(r["B"] == 1 and r["Mp"] == 256 and r["pairs"] > 0
               for r in recs)


def test_walk_split_on_shapes_on_the_cpu():
    # the part segmenter's shapes (xyz as features), and the share of the
    # k-steps the cull keeps: the plain walk_cull_share of each layer's walk
    recs = walk_split.main(["--device", "cpu", "--config",
                            "shapenetpart_tiny", "--shapes", "2",
                            "--layers", "0", "1"])
    assert [(r["request"], r["layer"], r["cin"]) for r in recs] == [
        ("shapes:2x128", 0, 3), ("shapes:2x128", 1, 8)]
    for r in recs:
        assert r["walk"] == "dense" and r["pairs"] > 0
        assert 0 < r["cull_share"] < 1


def test_instrumented_source_stays_out_of_the_main_build():
    assert walk_split.SOURCE not in tk._SOURCES
    with open(os.path.join(tk._CSRC, walk_split.SOURCE)) as f:
        assert "#define PW_WALK_SPLIT" in f.read()
    for src in tk._SOURCES + tk._HEADERS:
        with open(os.path.join(tk._CSRC, src)) as f:
            assert "#define PW_WALK_SPLIT" not in f.read()
    assert walk_split.BUILD_DIR.startswith(tk._BUILD_DIR + os.sep)


def test_walk_split_needs_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        walk_split.main(["--config", "seg_tiny_stream", "--points", "500"])
