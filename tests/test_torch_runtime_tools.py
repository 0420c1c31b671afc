"""The port's runtime helpers and profiler tools on the CPU.

``pointwise_torch.utils.runtime``: ``sync`` and ``timed`` on CPU tensors,
``profile_device_time`` returning None where the profiler sees no device
time (the CPU), the union rule of ``device_seconds`` on crafted overlapping
device events, ``StepWindow``, and the default device (the card: no card,
an error).  The tools ``attribute_train_step``, ``attribute_streaming`` and
``sweep_seg_conv`` run in this process with ``--device cpu`` at tiny sizes
and print their records with every device time "not measured"
(anchor_sweep, which starts processes, is in test_torch_anchor_sweep.py).
The output of scripts/prepare_s3dis.py and prepare_scenenn.py, which import
only numpy, is read by the port's loaders into the JAX loaders' arrays.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from pointwise_torch import infer
from pointwise_torch.data import s3dis as t_s3dis
from pointwise_torch.data import scenenn as t_scenenn
from pointwise_torch.tools import (attribute_streaming, attribute_train_step,
                                   sweep_seg_conv)
from pointwise_torch.utils import runtime
from pointwise_tpu.data import s3dis as j_s3dis
from pointwise_tpu.data import scenenn as j_scenenn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from prepare_s3dis import convert_room  # noqa: E402
from prepare_scenenn import convert_scene  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sync_and_timed_on_the_cpu():
    t = torch.arange(4.0)
    assert runtime.sync(t) == 6.0
    assert runtime.sync({"a": [t * 2]}) == 12.0
    assert runtime.sync([]) == 0.0 and runtime.sync(CPU) == 0.0
    lines = []
    with runtime.timed("step", sink=lines.append, device="cpu"):
        t.sum()
    assert len(lines) == 1
    assert lines[0].startswith("# [step] ") and lines[0].endswith(" ms")


def test_profile_device_time_is_none_without_device_time(tmp_path):
    calls = []
    assert runtime.profile_device_time(lambda: calls.append(1) or
                                       torch.ones(3), iters=3,
                                       device="cpu") is None
    assert len(calls) == 4                   # one before tracing, 3 traced
    with runtime.profile(os.fspath(tmp_path), device="cpu") as prof:
        torch.ones(8).sum()
    assert runtime.device_seconds(prof) == 0.0
    assert runtime.device_ops(prof) == {}
    assert (tmp_path / "trace.json").stat().st_size > 0


def _event(name, start, end, device=True, annotation=False):
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=kind.CUDA if device else kind.CPU,
        is_user_annotation=annotation)


def test_device_time_is_the_union_of_busy_intervals():
    # us: two streams overlap on [10, 15) and [40, 45); one event nests in
    # another; a CPU event and an annotation on the device's timeline (a
    # span over events and gaps) are no device time
    events = [_event("pw_walk_kernel<FwdMeans>", 0.0, 15.0),
              _event("pw_product_kernel<FwdProduct>", 10.0, 20.0),
              _event("pw_dw_reduce", 30.0, 50.0),
              _event("pw_dw_reduce", 40.0, 45.0),
              _event("Memcpy HtoD", 60.0, 60.5),
              _event("aten::mm", 0.0, 100.0, device=False),
              _event("Optimizer.step#AdamW.step", 25.0, 70.0,
                     annotation=True)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert runtime.device_seconds(prof) == pytest.approx(40.5e-6, abs=1e-15)
    ops = runtime.device_ops(prof)
    assert ops["pw_dw_reduce"] == (pytest.approx(25e-6), 2)
    total = sum(s for s, _ in ops.values())
    assert total == pytest.approx(50.5e-6)   # the overlaps counted twice
    fam = runtime.family_seconds(ops)
    assert fam["fwd_walk"] == pytest.approx(15e-6)
    assert fam["fwd_product"] == pytest.approx(10e-6)
    assert fam["dw_reduce"] == pytest.approx(25e-6)
    assert fam["other"] == pytest.approx(0.5e-6)
    top = runtime.top_ops(ops, 2, per=2)
    assert [t["op"] for t in top] == ["pw_dw_reduce",
                                      "pw_walk_kernel<FwdMeans>"]
    assert top[0]["ms"] == pytest.approx(12.5e-3) and top[0]["calls"] == 1
    assert runtime.interval_union_ns([(5, 9), (0, 3), (2, 4), (9, 10)]) == 9
    assert runtime.interval_union_ns([]) == 0


def test_step_window_times_and_traces_on_the_cpu():
    window = runtime.StepWindow("cpu", first=1, last=3, end=5)
    for step in range(1, 6):
        torch.ones(64, 64).sum()
        window(step)
    out = window.summary()
    assert out["timed_steps"] == [2, 3] and out["traced_steps"] == [4, 5]
    assert out["ms_per_step"] > 0
    assert out["device_ms_per_step"] == "not measured"
    with pytest.raises(ValueError):
        runtime.StepWindow("cpu", first=3, last=3, end=5)


def test_step_window_op_total_matches_back_to_back_busy_time():
    # three kernels back to back (ns 3133801, 554185, 4364019) over 6
    # traced steps: their float seconds summed by name read above the
    # union; the two totals must be equal
    window = runtime.StepWindow("cpu", first=1, last=2, end=8)
    window.marks = {1: 0.0, 2: 1.0, 8: 2.0}
    events = [_event("a", 0.0, 3133.801), _event("b", 3133.801, 3687.986),
              _event("c", 3687.986, 8052.005)]
    window.prof = types.SimpleNamespace(events=lambda: events)
    out = window.summary()
    assert out["op_ms_per_step"] == out["device_ms_per_step"]
    assert out["device_ms_per_step"] == 8052005 / 1e6 / 6


def test_runtime_and_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: runtime.timed("x").__enter__(),
                 lambda: runtime.profile_device_time(lambda: None),
                 lambda: runtime.StepWindow("cuda", 1, 2, 3),
                 lambda: attribute_train_step.main(["--config", "cls_tiny"]),
                 lambda: attribute_streaming.main(["--points", "100"]),
                 lambda: sweep_seg_conv.main(["--quick"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _records(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("config", ["cls_tiny", "seg_tiny_local"])
def test_attribute_train_step_on_the_cpu(config, capsys):
    rec = attribute_train_step.main(["--config", config, "--steps", "2",
                                     "--device", "cpu"])
    assert _records(capsys.readouterr().out) == [rec]
    assert rec["config"] == config and rec["device"] == "cpu"
    assert rec["timed_steps"] == [2, 3] and rec["traced_steps"] == [4, 5]
    assert rec["ms_per_step"] > 0
    assert rec["device_ms_per_step"] == "not measured"
    assert "host_share" not in rec and "top" not in rec


def test_attribute_streaming_on_the_cpu(capsys, monkeypatch):
    # an 800-point room in place of the procedural scene, whose smallest
    # size (two 4,096-point objects) the CPU's dense reference streams
    # too slowly for a test
    def scene(n_points, seed=0, num_classes=5):
        rng = np.random.RandomState(seed)
        return (rng.uniform(0.0, 2.5, (n_points, 3)).astype(np.float32),
                rng.uniform(0.0, 1.0, (n_points, 3)).astype(np.float32),
                rng.randint(0, num_classes, n_points))

    monkeypatch.setattr(infer, "big_scene", scene)
    recs = attribute_streaming.main(["--config", "seg_tiny_stream",
                                     "--points", "800", "--tile-size",
                                     "1.5", "--device", "cpu"])
    assert _records(capsys.readouterr().out) == recs
    assert [r["pass"] for r in recs] == ["warm", "steady", "steady_traced"]
    for r in recs:
        assert r["n_points"] == 800 and r["pts_per_s"] > 0
        assert r["n_jobs"] >= 1 and r["dispatch_s"] >= 0
    assert recs[-1]["device_s"] == "not measured"


def test_sweep_seg_conv_on_the_cpu(capsys):
    recs = sweep_seg_conv.main(["--batch", "1", "--points", "256",
                                "--device", "cpu"])
    assert _records(capsys.readouterr().out) == recs
    assert [(r["layer"], r["walk"]) for r in recs] == [
        (layer, walk) for layer in range(4)
        for walk in ("auto", "csr", "dense")]
    assert [r["csr"] for r in recs[:3]] == [False, True, False]
    assert [r["cin"] for r in recs[::3]] == [6, 124, 124, 124]
    for r in recs:
        assert all(r[k] == "not measured" for k in ("fwd_ms", "dW_ms",
                                                    "dX_ms"))


def _same_rooms(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_prepared_data_read_by_the_port_loaders(tmp_path):
    from test_prepare_scripts import _write_ply

    rng = np.random.RandomState(0)
    ann = tmp_path / "Area_1_room1" / "Annotations"
    ann.mkdir(parents=True)
    for name, n in (("wall_1", 100), ("chair_3", 50), ("gizmo_9", 10)):
        np.savetxt(ann / f"{name}.txt", np.concatenate(
            [rng.uniform(0, 3, (n, 3)), rng.randint(0, 255, (n, 3))], 1),
            fmt="%.4f")
    rooms = tmp_path / "s3dis"
    rooms.mkdir()
    np.save(rooms / "Area_1_room1.npy",
            convert_room(os.fspath(tmp_path / "Area_1_room1")))
    got = t_s3dis.load_rooms(os.fspath(rooms))
    _same_rooms(got, j_s3dis.load_rooms(os.fspath(rooms)))
    assert len(got[0][0]) == 160 and set(got[0][2]) == {2, 8, 12}

    d = tmp_path / "scene"
    d.mkdir()
    n = 120
    _write_ply(d / "005.ply", rng.uniform(0, 4, (n, 3)).astype(np.float32),
               rng.randint(0, 255, (n, 3)).astype(np.uint8),
               np.where(np.arange(n) < 60, 5, 9).astype(np.uint16), True)
    (d / "005.xml").write_text('<scene><label id="5" nyu_class="chair"/>'
                               '<label id="9" text="floor"/></scene>')
    scenes = tmp_path / "scenenn"
    scenes.mkdir()
    np.save(scenes / "scenenn_005.npy",
            convert_scene(os.fspath(d / "005.ply"), os.fspath(d / "005.xml")))
    got = t_scenenn.load_scenes(os.fspath(scenes))
    _same_rooms(got, j_scenenn.load_scenes(os.fspath(scenes)))
    assert len(got[0][0]) == n
