#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py          # one card; every phase runs, always

Phases, each printing one JSON line:
  device   the card's name, count and power limit (nvidia-smi);
  build    nvcc builds the forward kernel from kernels/csrc/ (first use);
  parity   kernel vs its plain PyTorch version on the card, dense and CSR
           walks, f32 and bf16, B=4, p=4096/8192, Cin=6/124, Cout=124,
           centers != candidates, masked centers, sentinel padding and a
           crafted grid with pairs at exactly the radius and on cell faces;
  serve    the full-width s3dis_synthetic segmenter (numpy-seeded weights
           through convert.py) served by infer.serve(): warm-up on a 200K
           scene, then synth:200000, synth:1000000 and a small-object scan
           file (2,016 points, the only request whose tiles take the dense
           walk); the launch counters are zeroed just before and read just
           after, and both walk modes must have launched;
  trace    one more 200K scene under torch.profiler: the device's busy
           and idle share of the request and its costliest device ops;
  exact    streamed logits == a direct full-scene forward on a ~20K scene
           (f32 convs, 2e-4);
  times    each walk mode timed with CUDA events per layer, beside the
           plain version, the roofline bound of those inputs and the max
           error: the CSR walk on the largest conv call the serve phase
           made, the dense walk on a full batch of four small-object scans
           (a direct forward of the served model, captured the same way).
Then the ``kernels`` line, the nvidia-smi line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # f32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 tensor cores, dense
KERNELS = {
    "fwd_dense": "pointwise_tpu/kernels/pointwise_conv_pallas.py:320",
    "fwd_csr": "pointwise_tpu/kernels/pointwise_conv_pallas.py:599",
}
SOURCE = "pointwise_torch/kernels/csrc/pointwise_conv_fwd.cu"


def emit(rec):
    print(json.dumps(rec), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def crafted_grid(radius, origin, n=7):
    """n^3 points on a grid of spacing r/3 (dyadic r): many pairs at exactly
    the radius and exactly on cell faces."""
    import numpy as np

    s = np.float32(radius / 3.0)
    g = np.stack(np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3)), -1)
    return (g.reshape(-1, 3) * s + np.float32(origin)).astype(np.float32)


def parity_inputs(dev, b, p, cin, cout, radius, seed):
    """Morton-ordered crops of a synthetic scene, a crafted grid, masks and
    sentinel padding; centers are a masked subset of each crop."""
    import numpy as np
    import torch

    from pointwise_torch.data import synthetic
    from pointwise_torch.utils.spatial import morton_sort

    rng = np.random.RandomState(seed)
    xyz, _, _ = synthetic.segmentation_scene(seed, num_objects=6,
                                             points_per_obj=4096, room=3.0)
    grid = crafted_grid(radius, (1.5, 1.5, 0.25))
    n_real = p - 37                     # the tail is sentinel padding
    clouds = []
    for _ in range(b):
        pick = xyz[rng.choice(len(xyz), n_real - len(grid), replace=False)]
        clouds.append(morton_sort(np.concatenate([pick, grid])))
    pts = np.stack(clouds)
    nc = (3 * n_real) // 4
    ctr = np.stack([c[np.sort(rng.choice(n_real, nc, replace=False))]
                    for c in clouds])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    return dict(points=t(pts), features=t(rng.standard_normal((b, n_real, cin))),
                weights=t(rng.standard_normal((27, cin, cout))
                          / np.sqrt(27 * cin)),
                bias=t(rng.standard_normal(cout) * 0.1),
                mask=t(rng.rand(b, n_real) > 0.1), centers=t(ctr),
                center_mask=t(rng.rand(b, nc) > 0.1))


def compare(y, y_ref, precision):
    """(max abs error, ok) at the stated tolerance: f32 atol/rtol 1e-4; bf16
    2e-2 relative to max |y_ref|."""
    err = float((y - y_ref).abs().max())
    if precision == "float32":
        ok = bool(((y - y_ref).abs() <= 1e-4 + 1e-4 * y_ref.abs()).all())
    else:
        ok = err <= 2e-2 * float(y_ref.abs().max())
    return err, ok


def phase_parity(dev, sizes=(4096, 8192), batch=4):
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops.pointwise_conv import conv_layout

    cases = []
    for p in sizes:
        for cin, radius in ((6, 0.09375), (124, 0.375)):
            inp = parity_inputs(dev, batch, p, cin, 124, radius, seed=p + cin)
            for csr in (False, True):
                for precision in ("float32", "bfloat16"):
                    kw, _ = conv_layout(
                        inp["points"], inp["features"], inp["weights"],
                        inp["bias"], radius=radius, mask=inp["mask"],
                        centers=inp["centers"],
                        center_mask=inp["center_mask"], precision=precision,
                        csr=csr)
                    y, cnt = tk.conv_fwd(**kw)
                    y_p, cnt_p = tk.conv_fwd_plain(**kw)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err, ok = compare(y, y_p, precision)
                    cnt_equal = bool(torch.equal(cnt, cnt_p))
                    cases.append(dict(p=p, cin=cin, radius=radius,
                                      walk="csr" if csr else "dense",
                                      precision=precision, max_abs_err=err,
                                      pairs=int(cnt.sum()),
                                      counts_equal=cnt_equal, ok=ok))
                    if not (ok and cnt_equal):
                        emit({"phase": "parity", "failed": cases[-1]})
                        raise AssertionError(f"kernel != plain: {cases[-1]}")
    emit({"phase": "parity", "ok": True, "cases": cases})


class ConvRecorder:
    """Forward hooks on every PointwiseConv: keeps, per (walk mode, layer),
    the inputs of the largest call, so the times phase runs the kernel at
    the shapes the served path gave it."""

    def __init__(self, model):
        from pointwise_torch.ops.pointwise_conv import csr_walk

        self.calls = {}
        self.handles = []
        for layer, blk in enumerate(model.blocks):
            def hook(mod, args, out, layer=layer):
                points, x, mask, centers, center_mask = args
                key = ("fwd_csr" if csr_walk(points.shape[1]) else
                       "fwd_dense", layer)
                nc = (points if centers is None else centers).shape[1]
                size = points.shape[0] * points.shape[1] * nc
                if size > self.calls.get(key, (0,))[0]:
                    self.calls[key] = (size, mod, args)
            self.handles.append(blk.conv.register_forward_hook(hook))

    def remove(self):
        for h in self.handles:
            h.remove()


def small_scan(seed):
    """A small-object scan: one object on a 0.7 m x 0.7 m patch of floor,
    2,016 points (~4,100 per m^2, the density of ``infer.big_scene``).
    Its one tile pads to 2,048 candidates, under the 8 x 512 of the CSR
    walk, so the dense walk serves it; no room-scale scene reaches it."""
    from pointwise_torch.data import synthetic

    return synthetic.segmentation_scene(seed, num_objects=1,
                                        points_per_obj=1344, room=0.7)


def small_scan_file(path, seed=0):
    """``small_scan`` as a .npy request (xyz + rgb + label)."""
    import numpy as np

    xyz, rgb, lab = small_scan(seed)
    np.save(path, np.concatenate([xyz, rgb, lab[:, None]], 1).astype(
        np.float32))
    return path


def phase_serve(dev, workdir, warm_points=200_000,
                requests=("synth:200000", "synth:1000000")):
    import torch

    from pointwise_torch import infer
    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.train import get_config

    args = infer.parse_args([
        "--serve", "--config", "s3dis_synthetic", "--device", dev.type,
        "--warm-points", str(warm_points),
        "--profile-file", os.path.join(workdir, "profiles.json")])
    cfg = get_config(args.config)
    model = infer.build_model(cfg, dev)          # numpy seed -> convert.py
    recorder = ConvRecorder(model)
    replies = []
    requests = [*requests, small_scan_file(os.path.join(workdir, "scan.npy"))]

    def collect(rec):
        replies.append(rec)
        emit({"phase": "serve", "reply": rec})

    tk.reset_launches()
    infer.serve(args, cfg, model, requests=list(requests), emit=collect)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    recorder.remove()
    emit({"phase": "serve", "launches": launches})
    bad = [r for r in replies if "error" in r]
    if bad or len(replies) != 1 + len(requests) or not replies[0].get("ready"):
        raise AssertionError(f"serve failed: {replies}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a walk mode never launched: {launches}")
    for r in replies[1:]:
        if not (0.0 <= r["accuracy"] <= 1.0 and r["pts_per_s"] > 0):
            raise AssertionError(f"bad reply {r}")
    if "output" not in replies[-1]:
        raise AssertionError("the scene-file request wrote no prediction")
    return launches, replies[1:], recorder.calls, model


def dense_calls(dev, model, batch=4):
    """The dense walk's conv calls, per layer, of a direct forward of the
    served model on a full batch of ``batch`` small-object scans."""
    import numpy as np
    import torch

    from pointwise_torch import infer
    from pointwise_torch.train import get_config

    cfg = get_config("s3dis_synthetic")
    scans = [small_scan(seed) for seed in range(1, batch + 1)]
    xyz = np.stack([s[0] for s in scans])
    feats = np.stack([infer.scene_features(cfg, s[0], s[1]) for s in scans])
    recorder = ConvRecorder(model)
    with torch.inference_mode():
        model(torch.from_numpy(xyz).to(dev),
              torch.from_numpy(feats.astype(np.float32)).to(dev),
              torch.ones(xyz.shape[:2], device=dev))
    recorder.remove()
    if sorted(recorder.calls) != [("fwd_dense", i)
                                  for i in range(len(model.blocks))]:
        raise AssertionError(f"the scans did not take the dense walk: "
                             f"{sorted(recorder.calls)}")
    return recorder.calls


def phase_trace(dev, n_points=200_000, top=8):
    """Device busy share of one served scene and its costliest device ops
    (torch.profiler; CUPTI).  Reports "not measured" when the profiler sees
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointwise_torch import infer
    from pointwise_torch.streaming import stream_apply_layered
    from pointwise_torch.train import get_config

    cfg = get_config("s3dis_synthetic")
    model = infer.build_model(cfg, dev)
    xyz, rgb, _ = infer.big_scene(n_points, seed=2)
    feats = infer.scene_features(cfg, xyz, rgb)

    def run():
        stream_apply_layered(infer.layered_apply(model), xyz, feats,
                             radii=cfg.radii, tile_size=4.0,
                             out_dim=cfg.num_classes, device=dev)
        torch.cuda.synchronize()

    run()                                           # allocator warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    dev_ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in dev_ops) / 1e6
    rec = {"phase": "trace", "n_points": len(xyz), "wall_s": wall}
    if busy <= 0:
        rec["device_busy_s"] = "not measured"
    else:
        rec.update(device_busy_s=busy, device_idle_share=1.0 - busy / wall,
                   top=[{"op": e.key[:80], "ms": dev_us(e) / 1e3,
                         "calls": e.count}
                        for e in sorted(dev_ops, key=dev_us,
                                        reverse=True)[:top]])
    emit(rec)


def phase_exact(dev, n_points=20_000):
    import numpy as np
    import torch

    from pointwise_torch import infer
    from pointwise_torch.streaming import stream_apply_layered
    from pointwise_torch.train import get_config

    cfg = get_config("s3dis_synthetic")
    model = infer.build_model(cfg, dev, precision="float32")
    xyz, rgb, _ = infer.big_scene(n_points, seed=1)
    feats = infer.scene_features(cfg, xyz, rgb)
    streamed = stream_apply_layered(
        infer.layered_apply(model), xyz, feats, radii=cfg.radii,
        tile_size=1.5, out_dim=cfg.num_classes, device=dev)
    with torch.inference_mode():
        direct = model(torch.from_numpy(xyz[None]).to(dev),
                       torch.from_numpy(feats[None].astype(np.float32)).to(dev),
                       torch.ones(1, len(xyz), device=dev))[0].cpu().numpy()
    err = float(np.abs(streamed - direct).max())
    emit({"phase": "exact", "n_points": len(xyz), "max_abs_err": err,
          "max_abs_logit": float(np.abs(direct).max()), "tol": 2e-4})
    if not err <= 2e-4:
        raise AssertionError(f"streamed != direct: {err}")


def cuda_time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(kw, y, cnt, centers):
    """Least time (ms) the card needs for this call, the larger of two:
    the bytes moved (each input read once, each output written once; of the
    CSR walk's tile list only its offsets and the nnz indices it holds)
    over HBM bandwidth, and the work these inputs need over the peak rate
    of its type.  The work is two parts that different units can run at
    once, so the slower one bounds it: the cell-sum adds of the in-ball
    pairs (f32, CUDA cores) and the (27*Cin) x Cout product of the
    ``centers`` real centers (tensor cores in the matmul type)."""
    ins = [kw[k] for k in ("ctr", "pts", "feats", "w", "bias", "tile_ptr",
                           "tile_idx") if kw[k] is not None]
    nbytes = sum(t.numel() * t.element_size() for t in ins + [y, cnt])
    cin, cout = kw["w"].shape[1], kw["w"].shape[2]
    pairs = float(cnt.sum())
    t_ops = max(pairs * cin / F32_FLOPS, 2.0 * 27 * cin * cout * centers / (
        BF16_FLOPS if kw["feats"].dtype.itemsize == 2 else F32_FLOPS))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, pairs)


def phase_times(calls):
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops.pointwise_conv import conv_layout

    rows = []
    for (name, layer), (_, mod, args) in sorted(calls.items()):
        points, x, mask, centers, center_mask = args
        with torch.inference_mode():
            kw, (_, nc, cmask) = conv_layout(
                points, x, mod.kernel, mod.bias, radius=mod.radius,
                mask=mask, centers=centers, center_mask=center_mask,
                precision=mod.precision)
            if (kw["tile_idx"] is not None) != (name == "fwd_csr"):
                raise AssertionError("walk mode changed between runs")
            y, cnt = tk.conv_fwd(**kw)
            y_p, _ = tk.conv_fwd_plain(**kw)
            err, ok = compare(y, y_p, mod.precision)
            ms = cuda_time_ms(lambda: tk.conv_fwd(**kw), reps=5)
            plain_ms = cuda_time_ms(lambda: tk.conv_fwd_plain(**kw), reps=1,
                                    warmup=0)
        real = (points.shape[0] * nc if cmask is None
                else float(cmask.sum()))
        bound_ms, bound_by, nbytes, pairs = bound(kw, y, cnt, real)
        rows.append(dict(name=name, layer=layer, radius=mod.radius,
                         shape=dict(B=int(points.shape[0]),
                                    Mp=int(kw["pts"].shape[1]),
                                    Ncp=int(kw["ctr"].shape[1]),
                                    cin=int(kw["w"].shape[1]),
                                    cout=int(kw["w"].shape[2])),
                         precision=mod.precision, pairs=pairs, bytes=nbytes,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=err, ok=ok))
        emit({"phase": "times", **rows[-1]})
        if not ok:
            raise AssertionError(f"kernel != plain at the served shape: "
                                 f"{rows[-1]}")
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import pointwise_torch  # noqa: F401
        from pointwise_torch.kernels import pointwise_conv_cuda as tk
    except ImportError as e:
        print(f"chip_smoke: the pointwise_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t_all = time.perf_counter()

    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    tk.build_libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in tk.LIBRARY["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln]})
    phase_parity(dev)
    os.makedirs(tk._BUILD_DIR, exist_ok=True)     # ignored by git
    with tempfile.TemporaryDirectory(dir=tk._BUILD_DIR) as workdir:
        launches, _, served, model = phase_serve(dev, workdir)
    phase_trace(dev)
    phase_exact(dev)
    calls = {k: v for k, v in served.items() if k[0] == "fwd_csr"}
    calls.update(dense_calls(dev, model))
    rows = phase_times(calls)
    kernels = []
    for name, replaces in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        top = max(mine, key=lambda r: r["ms"])    # the costliest layer
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shape": top["shape"],
            "layer": top["layer"], "precision": top["precision"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
