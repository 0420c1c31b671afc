"""``python -m pointwise_torch.infer --serve --dp`` on 2 spawned gloo ranks.

Mirrors tests/test_serve.py's protocol (its ``--dp`` case) for the port:
the ready line, a scene file answered with a ``.pred.npy`` and metrics, an
error reply for ``does_not_exist.npy`` while both ranks keep serving, an
identical repeat answered identically, and ``quit`` ending every rank.
Only rank 0 emits and prints.  The sharded replies equal the single-device
server's on the same requests (the predictions bit for bit: a data axis
changes no row's arithmetic on the plain path).  A failure inside the
engine on one rank alone takes every rank down at once instead of leaving
the others in a collective.  Also the refusals of the parallel paths.
"""

import os
import types

import numpy as np
import pytest
import torch

from pointwise_torch import infer, streaming
from pointwise_torch.parallel import launch

RUN_LIMIT = 240       # seconds for one spawned run, start to end
ARGV = ["--config", "seg_tiny_stream", "--serve", "--device", "cpu",
        "--warm-points", "0", "--tile-size", "1.5", "--tile-batch", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def room_file(path, n=1200, seed=0):
    rng = np.random.RandomState(seed)
    room = np.concatenate([rng.uniform(0.0, 2.5, (n, 3)),
                           rng.uniform(0.0, 1.0, (n, 3)),
                           rng.randint(0, 5, (n, 1))], axis=1)
    np.save(path, room.astype(np.float32))
    return os.fspath(path)


def failing_serve_worker(mesh, *, argv, requests):
    """``launch.serve_worker`` with the engine's model raising on rank 1
    alone (spawned: this module imports nothing of JAX)."""
    layered_apply = infer.layered_apply

    def planted(model):
        apply = layered_apply(model)

        def fail_on_rank_1(*args, **kw):
            if mesh.rank == 1:
                raise RuntimeError("planted failure on rank 1")
            return apply(*args, **kw)
        return fail_on_rank_1

    infer.layered_apply = planted
    return launch.serve_worker(mesh, argv=argv, requests=requests)


def _without_timing(rec):
    return {k: v for k, v in rec.items()
            if k not in ("seconds", "pts_per_s", "load_s", "phases")}


def test_serve_protocol_on_two_ranks(tmp_path):
    room = room_file(tmp_path / "room.npy")
    prof = os.fspath(tmp_path / "profiles.json")
    requests = [room, "does_not_exist.npy", room, "quit", "synth:5000"]
    single = []
    infer.main(ARGV + ["--profile-file", prof], requests=requests,
               emit=single.append)
    pred_single = np.load(single[1]["output"])
    os.remove(single[1]["output"])

    res = launch.spawn(
        launch.serve_worker, 2, os.fspath(tmp_path / "ranks"), data=2,
        device="cpu", timeout=RUN_LIMIT,
        kwargs=dict(argv=ARGV + ["--dp", "--profile-file", prof],
                    requests=requests))
    lead, other = res
    assert other["replies"] == [] and other["stdout"] == ""
    assert lead["stdout"].splitlines() == ["# tile batches over data:2"]
    ready, first, bad, second = lead["replies"]       # nothing after quit
    assert ready == {"ready": True}
    assert first["scene"] == room and first["n_points"] == 1200
    assert first["pts_per_s"] > 0 and 0.0 <= first["miou"] <= 1.0
    pred = np.load(first["output"])
    assert pred.shape == (1200,) and pred.dtype == np.int32
    np.testing.assert_array_equal(pred, pred_single)
    assert bad["scene"] == "does_not_exist.npy" and "error" in bad
    assert "FileNotFoundError" in bad["error"]
    assert _without_timing(second) == _without_timing(first)
    for got, want in zip(lead["replies"], single):
        assert _without_timing(got) == _without_timing(want)
    # both ranks streamed both scene requests (the warm-up is off), each
    # holding the whole scene: there is no space axis
    for r in res:
        assert r["scenes"] == [{"points": 1200,
                                "resident_bytes": 1200 * 9 * 4}] * 2
    assert infer.load_profiles(prof)


def test_parallel_refusals():
    xyz = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="mesh"):
        streaming.stream_apply_layered(None, xyz, xyz, radii=(0.5,),
                                       tile_size=1.0, out_dim=2,
                                       device="cpu", scene_axis="space")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2 -m "
                                           "pointwise_torch.infer"):
        infer.main(ARGV + ["--sp", "2"], requests=["quit"], emit=print)
    with pytest.raises(ValueError, match="layered"):
        infer.main(["--config", "seg_tiny_stream", "--device", "cpu",
                    "--no-layered", "--dp"])


def test_engine_failure_on_one_rank_ends_every_rank(tmp_path):
    # without the re-raise, rank 1 would reply and wait for the next
    # request while rank 0 waits in the chunk's logits gather: both hang
    # until the collective timeout (longer than the run's limit here)
    room = room_file(tmp_path / "room.npy")
    with pytest.raises(RuntimeError, match="exited with code"):
        launch.spawn(failing_serve_worker, 2, os.fspath(tmp_path / "ranks"),
                     data=2, device="cpu", timeout=90, comm_timeout=600,
                     kwargs=dict(argv=ARGV + ["--dp"],
                                 requests=[room, room, "quit"]))


def test_rank_resolution_checks_a_given_mesh():
    cpu = torch.device("cpu")
    mesh = types.SimpleNamespace(device=cpu, space=2)
    assert launch.resolve_rank("cpu", False, 2, mesh, "prog") == (cpu, mesh)
    with pytest.raises(ValueError, match="--sp 1 but the mesh has space=2"):
        launch.resolve_rank("cpu", True, 1, mesh, "prog")
    with pytest.raises(ValueError, match="--sp 0 but the mesh has space=2"):
        launch.resolve_rank("cpu", True, 0, mesh, "prog")
    assert launch.resolve_rank("cpu", False, 0, None, "prog") == (cpu, None)
