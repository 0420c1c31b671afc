"""The port's serving CLI (``python -m pointwise_torch.infer``) on the CPU.

Mirrors tests/test_serve.py for the port: the JSONL protocol end to end
(ready handshake, scene-file inference with .pred.npy output and metrics,
error replies that do NOT kill the server, deterministic repeat replies,
length-profile persistence), JAX-layout ``--params`` weights, the one-shot
path, and the device rule: without a card an explicit or default ``cuda``
request fails instead of falling back to the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointwise_torch.convert import random_segmenter_params
from pointwise_torch.infer import load_profiles, main
from pointwise_torch.train import get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "pointwise_torch.infer"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CPU paths run many small ops; with the test workers sharing the
    # cores, more intra-op threads only add contention
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args, stdin="", timeout=600):
    return subprocess.run(CLI + args, input=stdin, capture_output=True,
                          text=True, cwd=REPO, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_serve_keepalive_cpu(tmp_path):
    rng = np.random.RandomState(0)
    n = 1200
    xyz = rng.uniform(0.0, 2.5, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    lab = rng.randint(0, 5, n).astype(np.float32)
    room_path = tmp_path / "room.npy"
    np.save(room_path, np.concatenate([xyz, rgb, lab[:, None]], axis=1))
    prof_path = tmp_path / "profiles.json"
    requests = "\n".join([
        str(room_path),
        "does_not_exist.npy",   # error reply; the server must keep going
        str(room_path),         # identical request -> identical reply
        "quit",
    ]) + "\n"
    out = _run(["--config", "seg_tiny_stream", "--serve", "--device", "cpu",
                "--warm-points", "0", "--profile-file", os.fspath(prof_path),
                "--tile-size", "1.5", "--tile-batch", "2"], requests)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert lines and lines[0].get("ready") is True, lines[:1]
    first, bad, second = lines[1:]

    assert first["scene"] == str(room_path) and first["n_points"] == n
    assert first["pts_per_s"] > 0
    assert 0.0 <= first["accuracy"] <= 1.0 and 0.0 <= first["miou"] <= 1.0
    pred = np.load(first["output"])
    assert pred.shape == (n,) and pred.dtype == np.int32
    assert pred.min() >= 0 and pred.max() < 5
    assert "error" in bad and bad["scene"] == "does_not_exist.npy"
    # keep-alive determinism
    assert second["accuracy"] == first["accuracy"]
    assert second["miou"] == first["miou"]
    np.testing.assert_array_equal(np.load(second["output"]), pred)
    # no kernel library on the CPU path: nothing is built or loaded
    for rec in (first, second):
        assert rec["compiled"] is False and rec["new_programs"] == 0
        assert rec["compile_s"] == 0.0

    profiles = load_profiles(os.fspath(prof_path))
    assert profiles, "length profiles must be persisted"
    for b, (tbs, lengths) in profiles.items():
        assert isinstance(b, int) and tbs >= 1
        assert all(isinstance(x, int) and x > 0 for x in lengths)


def test_one_shot_with_params(tmp_path):
    cfg = get_config("seg_tiny_stream")
    flat = random_segmenter_params(cfg.in_features, cfg.num_classes,
                                   channels=cfg.channels,
                                   head_dims=cfg.head_dims, seed=3)
    params = tmp_path / "w.npz"
    np.savez(params, **flat)
    rng = np.random.RandomState(1)
    n = 1000
    room = np.concatenate([rng.uniform(0.0, 2.0, (n, 3)),
                           rng.uniform(0.0, 255.0, (n, 3)),
                           rng.randint(0, 5, (n, 1))], axis=1)
    (tmp_path / "rooms").mkdir()
    np.save(tmp_path / "rooms" / "a.npy", room.astype(np.float32))
    out = _run(["--config", "seg_tiny_stream", "--device", "cpu",
                "--params", os.fspath(params),
                "--data-dir", os.fspath(tmp_path / "rooms"),
                "--tile-size", "1.5", "--repeat", "2",
                "--save-ply", os.fspath(tmp_path / "p.ply")])
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "streaming_points_per_sec" and rec["value"] > 0
    assert rec["n_points"] == n and rec["device"] == "cpu"
    assert rec["passes"] == 2
    assert (tmp_path / "p.ply").stat().st_size > 0


def test_cuda_request_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["--config", "seg_tiny_stream", "--serve", "--warm-points",
                "0"], "quit\n")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ready"' not in out.stdout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", "seg_tiny_stream", "--device", "cuda"])


@pytest.mark.parametrize("extra", [["--sp", "2"], ["--checkpoint-dir", "x"]])
def test_not_yet_ported_flags_fail(extra, tmp_path):
    # what the port refuses: --sp without a launcher (the torchrun command
    # is named; no process group is left behind) and a numbered step
    # directory that orbax never committed (the JAX trainer's committed
    # steps are served: test_torch_jax_checkpoint.py)
    import torch.distributed as dist

    want = {"--sp": (RuntimeError, "torchrun --nproc-per-node 2"),
            "--checkpoint-dir": (FileNotFoundError, "x: no committed orbax")}
    err, match = want[extra[0]]
    if extra[0] == "--checkpoint-dir":
        (tmp_path / "x" / "3").mkdir(parents=True)
        extra = [extra[0], os.fspath(tmp_path / "x")]
    with pytest.raises(err, match=match):
        main(["--config", "seg_tiny_stream", "--device", "cpu"] + extra)
    assert not dist.is_initialized()


def test_serves_a_trained_checkpoint(tmp_path):
    # the port's trainer writes the checkpoint; infer serves it
    from pointwise_torch.train.cli import main as train_main
    from pointwise_torch.train.trainer import checkpoint_steps

    ck = os.fspath(tmp_path / "ck")
    trainer = train_main(["--config", "seg_tiny_local", "--steps", "2",
                          "--device", "cpu", "--checkpoint-dir", ck])
    assert checkpoint_steps(ck) == [2]
    rng = np.random.RandomState(2)
    n = 600
    room = np.concatenate([rng.uniform(0.0, 1.5, (n, 3)),
                           rng.uniform(0.0, 1.0, (n, 3)),
                           rng.randint(0, 5, (n, 1))], axis=1)
    room_path = tmp_path / "room.npy"
    np.save(room_path, room.astype(np.float32))
    out = _run(["--config", "seg_tiny_local", "--serve", "--device", "cpu",
                "--warm-points", "0", "--checkpoint-dir", ck,
                "--tile-size", "1.5"], f"{room_path}\nquit\n")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0].get("ready") is True and len(lines) == 2, lines
    reply = lines[1]
    assert reply["n_points"] == n and 0.0 <= reply["accuracy"] <= 1.0
    pred = np.load(reply["output"])
    assert pred.shape == (n,) and pred.min() >= 0 and pred.max() < 5
    # the served weights are the trained ones, not a fresh seed's
    from pointwise_torch.infer import build_model

    served = build_model(get_config("seg_tiny_local"), torch.device("cpu"),
                         checkpoint_dir=ck)
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(served.state_dict()[k], v, rtol=0, atol=0)
