"""The port's bench (``python -m pointwise_torch.bench``) on the CPU.

Its train and segmentation batches equal, array for array, the ones the
root bench.py builds from the JAX package's data modules; its utilization
counts are bench.py's useful-count formulas, written out here; each arm
runs on ``device="cpu"`` at tiny sizes with finite rates; ``main`` prints
the diagnostics on stderr and bench.py's four-key line last, with NaN for
``vs_baseline`` and ``tf_cpu_error`` set when TensorFlow cannot be
imported; a failure planted in any other arm ends ``main`` with no result
line.  The arms' full sizes run only on the card (chip_smoke.py's bench
phase).
"""

import functools
import json
import math

import numpy as np
import pytest
import torch

from pointwise_torch import bench, infer
from pointwise_tpu.data import s3dis as j_s3dis
from pointwise_tpu.data import synthetic as j_synthetic
from pointwise_tpu.train.configs import SegmentationConfig as JaxSegConfig
from pointwise_tpu.utils import spatial as j_spatial

CPU = torch.device("cpu")
RESULT_KEYS = ["metric", "value", "unit", "vs_baseline"]
# diagnostics every run prints, whatever the device
DIAG_KEYS = ("device", "nvidia_smi", "torch", "cuda", "train_step_ms",
             "train_pts_per_s", "device_peak_bf16_tf", "fwd_pts_per_s",
             "fwdbwd_pts_per_s", "t_fwd_ms", "t_fwdbwd_ms",
             "t_fwd_device_ms", "t_fwdbwd_device_ms", "t_fwd_wall_ms",
             "t_fwdbwd_wall_ms", "precision", "c64_fwd_pts_per_s",
             "c64_t_fwd_ms", "seg_step_ms", "seg_pts_per_s",
             "seg_step_device_ms", "bwd_shape_canaries", "stream_pts_per_s",
             "stream_steady_s", "stream_1m_pts_per_s", "stream_1m_steady_s",
             "launches", "launches_by_arm", "max_memory_allocated_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_room(n_points, seed=0, num_classes=5):
    """A room of ``n_points`` in place of ``infer.big_scene``, whose
    smallest scene (two 4,096-point objects) the CPU's dense reference
    streams too slowly for a test."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.0, 2.0, (n_points, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (n_points, 3)).astype(np.float32),
            rng.randint(0, num_classes, n_points))


@pytest.fixture
def tiny(monkeypatch):
    """Every arm of ``bench.run`` at a tiny size on the CPU."""
    monkeypatch.setattr(infer, "big_scene", small_room)
    stream = bench.bench_streaming
    conv = bench.bench_conv_op
    for name, fn in (
            ("bench_train_step", functools.partial(
                bench.bench_train_step, B=2, N=64, steps=2)),
            ("calibrate_peak_bf16", functools.partial(
                bench.calibrate_peak_bf16, m=64, reps=2, iters=1)),
            # 124 -> 7 and 64 -> 4 wide
            ("bench_conv_op", lambda dev, cin, cout, peak_measured: conv(
                dev, B=2, N=128, cin=cin // 16, cout=cout // 16,
                peak_measured=peak_measured)),
            ("bench_seg_step", functools.partial(
                bench.bench_seg_step, B=1, N=64, steps=1)),
            ("probe_backward_shapes", functools.partial(
                bench.probe_backward_shapes, grad_shapes=((2, 128, 8),),
                bucket=(512, 256, 6, 8))),
            ("bench_streaming", lambda dev, n_points=200_000: stream(
                dev, 300 if n_points < 1_000_000 else 400,
                config="seg_tiny_stream"))):
        monkeypatch.setattr(bench, name, fn)


@pytest.fixture
def no_tensorflow(monkeypatch):
    # a None entry in sys.modules makes the import raise ImportError
    monkeypatch.setitem(__import__("sys").modules, "tensorflow", None)


def test_batches_equal_the_jax_bench():
    # bench.py's bench_train_step and bench_seg_step, from the JAX package
    pts, _ = j_synthetic.classification_set(0, 32, 1024)
    want = {"points": j_spatial.morton_sort_batch(pts),
            "label": np.random.RandomState(0).randint(0, 40, 32)}
    got = bench.train_batch()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = JaxSegConfig(name="bench", num_classes=5, batch_size=8,
                       num_points=4096)
    blocks = j_s3dis.training_blocks(cfg)
    want = {k: v[:8] for k, v in blocks.items() if k != "index"}
    port_cfg = bench.seg_config()
    got = bench.seg_batch(port_cfg)
    assert sorted(got) == sorted(want) and len(want["points"]) == 8
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (port_cfg.channels, port_cfg.radii, port_cfg.head_dims,
            port_cfg.in_features, port_cfg.dropout) == (
        cfg.channels, cfg.radii, cfg.head_dims, cfg.in_features,
        cfg.dropout)


def jax_bench_useful_flops(B, N, cin, cout):
    # bench.py:338-344, written out
    npad = ((N + 127) // 128) * 128
    flops_bin_u = B * (npad // 128) * 27 * 2 * 128 * N * (cin + 1)
    flops_w_u = B * (npad // 128) * 27 * 2 * 128 * (cin + 1) * cout
    return flops_bin_u + flops_w_u


@pytest.mark.parametrize("shape", [(64, 1024, 124, 124), (3, 777, 6, 64)])
def test_conv_mfu_is_the_useful_count(shape, monkeypatch):
    B, N, cin, cout = shape
    flops = jax_bench_useful_flops(B, N, cin, cout)
    assert bench.useful_conv_flops(B, N, cin, cout) == flops
    # the op's arm at a tiny size, with the device time and peaks fed: the
    # MFU keys divide the count of the arm's own shape
    b, n, ci, co = 2, 96, 5, 7
    t_dev, peak, measured = 2e-3, 989.4e12, 700e12
    monkeypatch.setattr(bench, "device_time", lambda fn, dev, iters=4: t_dev)
    monkeypatch.setattr(bench, "peak_bf16", lambda dev: peak)
    out = bench.bench_conv_op(CPU, B=b, N=n, cin=ci, cout=co,
                              peak_measured=measured)
    small = jax_bench_useful_flops(b, n, ci, co)
    assert out["mfu_fwd"] == pytest.approx(small / t_dev / peak, rel=1e-12)
    assert out["mfu_fwdbwd"] == pytest.approx(3 * small / t_dev / peak,
                                              rel=1e-12)
    assert out["mfu_fwd_measured"] == pytest.approx(
        small / t_dev / measured, rel=1e-12)
    assert out["t_fwd_device_ms"] == out["t_fwd_ms"] == t_dev * 1e3


@pytest.mark.parametrize("shape", [(8, 4096, 6, (124, 124, 124, 124)),
                                   (2, 640, 3, (16, 32))])
def test_seg_mfu_is_the_useful_count(shape, monkeypatch):
    B, N, fin, channels = shape
    # bench.py:216-224 with each block's unpadded widths for its 128s:
    # forward and dW per block, dX for all but the first
    want = 0
    widths = [fin, *channels]
    for i, cout in enumerate(channels):
        cin = widths[i]
        flops_bin = B * (N // 128) * 27 * 2 * 128 * N * (cin + 1)
        flops_w = B * (N // 128) * 27 * 2 * 128 * (cin + 1) * cout
        want += (2 if i == 0 else 3) * (flops_bin + flops_w)
    assert bench.seg_step_flops(B, N, fin, channels) == want
    t_dev, peak = 5e-3, 989.4e12
    monkeypatch.setattr(bench, "device_time", lambda fn, dev, iters=4: t_dev)
    monkeypatch.setattr(bench, "peak_bf16", lambda dev: peak)
    _, _, extra = bench.bench_seg_step(CPU, B=1, N=64, steps=1)
    cfg = bench.seg_config(1, 64)
    assert extra["seg_mfu"] == pytest.approx(
        bench.seg_step_flops(1, 64, cfg.in_features, cfg.channels)
        / t_dev / peak, rel=1e-12)
    assert extra["seg_step_device_ms"] == t_dev * 1e3


def test_each_arm_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(infer, "big_scene", small_room)
    pps, dt = bench.bench_train_step(CPU, B=2, N=64, steps=2)
    assert math.isfinite(pps) and pps > 0 and dt > 0
    assert bench.calibrate_peak_bf16(CPU, m=64, reps=2, iters=1) is None
    conv = bench.bench_conv_op(CPU, B=2, N=128, cin=8, cout=8)
    for k in ("fwd_pts_per_s", "fwdbwd_pts_per_s", "t_fwd_ms",
              "t_fwdbwd_wall_ms"):
        assert math.isfinite(conv[k]) and conv[k] > 0, k
    assert conv["t_fwd_device_ms"] == "not measured"
    assert not any(k.startswith("mfu") for k in conv)
    pps, dt, extra = bench.bench_seg_step(CPU, B=1, N=64, steps=1)
    assert math.isfinite(pps) and pps > 0
    assert extra == {"seg_step_device_ms": "not measured"}
    bench.probe_backward_shapes(CPU, grad_shapes=((2, 128, 8),),
                                bucket=(512, 256, 6, 8))
    pps, dt = bench.bench_streaming(CPU, 300, config="seg_tiny_stream")
    assert math.isfinite(pps) and pps > 0 and dt > 0
    tf_pps = bench.bench_tf_cpu_op(B=1, N=64, cin=8, cout=8, iters=1)
    assert math.isfinite(tf_pps) and tf_pps > 0


def test_canary_refuses_non_finite_outputs(monkeypatch):
    conv = bench.pointwise_conv
    monkeypatch.setattr(bench, "pointwise_conv",
                        lambda *a, **kw: conv(*a, **kw) * float("nan"))
    with pytest.raises(AssertionError, match="non-finite"):
        bench.probe_backward_shapes(CPU, grad_shapes=(),
                                    bucket=(512, 256, 6, 8))


def test_main_prints_the_result_line_last(tiny, no_tensorflow, capsys):
    result = bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == RESULT_KEYS and last["value"] == result["value"]
    assert last["metric"] == "modelnet40_train_points_per_sec_per_chip"
    assert last["unit"] == "points/s" and last["value"] > 0
    assert math.isnan(last["vs_baseline"])
    diag = [ln for ln in err.splitlines() if ln.startswith("# {")]
    assert len(diag) == 1
    diag = json.loads(diag[0][2:])
    missing = [k for k in DIAG_KEYS if k not in diag]
    assert not missing, missing
    assert "tensorflow" in diag["tf_cpu_error"]
    assert [k for k in diag if k.endswith("_error")] == ["tf_cpu_error"]
    assert diag["device"] == "cpu" and diag["bwd_shape_canaries"] == "ok"
    assert diag["max_memory_allocated_bytes"] == "not measured"
    assert sorted(diag["launches_by_arm"]) == sorted(
        ["train", "peak", "conv", "conv_c64", "seg", "canaries", "stream",
         "stream_1m"])
    # the plain versions launch nothing
    assert diag["launches"] == {}


# what each arm returns, for ``main`` to reach the arm that fails
STUBS = {"bench_train_step": (1.0, 1.0), "calibrate_peak_bf16": None,
         "bench_conv_op": {"fwdbwd_pts_per_s": 1.0},
         "bench_seg_step": (1.0, 1.0, {}), "probe_backward_shapes": None,
         "bench_streaming": (1.0, 1.0)}


@pytest.mark.parametrize("arm", list(STUBS))
def test_a_failed_arm_prints_no_result(arm, no_tensorflow, capsys,
                                       monkeypatch):
    def fail(*args, **kw):
        raise RuntimeError(f"planted failure in {arm}")

    for name, value in STUBS.items():
        monkeypatch.setattr(bench, name, lambda *a, _v=value, **kw: _v)
    monkeypatch.setattr(bench, arm, fail)
    with pytest.raises(RuntimeError, match="planted failure"):
        bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    assert "modelnet40_train_points_per_sec_per_chip" not in out
    assert "# {" not in err


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
