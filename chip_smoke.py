#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py          # one card; every phase runs, always

Phases, each printing one JSON line:
  device   the card's name, count and power limit (nvidia-smi);
  build    nvcc builds the forward, dW, dX and counts kernels from
           kernels/csrc/ (first use; one nvcc per source, all started
           together);
  parity   kernel vs its plain PyTorch version on the card, dense and CSR
           walks, f32 and bf16, B=4, p=4096/8192, Cin=6/124, Cout=124,
           centers != candidates, masked centers, sentinel padding and a
           crafted grid with pairs at exactly the radius and on cell faces;
           the counts kernel equals the plain counts and the forward's own
           counts bit for bit; the forward with external counts (counts
           over every candidate, a half of them as the slab) vs its plain
           version, and the ring's identity: the f32 sum of the external-
           counts forwards over 2 and over 4 disjoint candidate slabs
           equals the forward over all of them (the tolerance of ``compare``);
  serve    the full-width s3dis_synthetic segmenter (numpy-seeded weights
           through convert.py) served by infer.serve(): warm-up on a 200K
           scene, then synth:200000, synth:1000000 and a small-object scan
           file (2,016 points, the only request whose tiles take the dense
           walk); the launch counters are zeroed just before and read just
           after, and both walk modes must have launched;
  grad     the dW and dX kernels vs their plain versions on the parity
           phase's inputs (gradient g from a numpy seed), dense and CSR
           walks, f32 and bf16; two launches give identical bits and the
           two walks give identical bits; loss.backward() through
           pointwise_conv on CUDA tensors launches each gradient's walk
           (dw_*, dx_*) and product (dw_product, dx_product); dW and
           dX with the external counts of the parity phase vs their plain
           versions, bits identical run to run;
  train    the train CLI's function in-process at full width, 20 steps
           each: s3dis_synthetic_local (CSR walk) and modelnet40_synthetic
           (dense walk), checkpoints in a temp dir; finite loss, grad norm
           > 0, changed weights, the dw_*/dx_* launches of the walk (counts
           zeroed just before each run, read just after), ms/step after 2
           warm-up steps, trained points/s and the device idle share of
           two traced steps; a second run of the same seed, stopped at
           step 10 and resumed, must end on the same bits; then infer
           serves one 200K request from the segmentation checkpoint;
  trace    one more 200K scene under torch.profiler: the device's busy
           and idle share of the request, its device ms per kernel family
           and its costliest device ops (the train phase's traced steps
           give the same per step);
  exact    streamed logits == a direct full-scene forward on a ~20K scene
           (f32 convs, 2e-4);
  spatial  the ring and gather strategies of spatial parallelism.  (a) One
           process: the largest served CSR call (layer 3, 1 x 172,032
           candidates / 73,728 centers, 124 wide, bf16) split into 4
           candidate slabs through the public ops: pointwise_conv_counts on
           the whole set, 4 ext_counts partials summed in f32 against the
           forward (``compare``), with the CUDA-event ms of the counts call,
           each partial and the forward on the whole set.  (b) 2 ranks
           spawned on cuda:0 over gloo (host-staged; NCCL refuses two ranks
           on one card), s3dis_synthetic_local at full width, 8 x 4096, bf16,
           dropout and jitter 0: 3 steps of the train CLI's function with
           --sp 2 (gather), 3 of Trainer(mesh, space_axis="space") with
           impl="spatial:space:ring", and 3 of a ring classifier at
           modelnet40_synthetic (32 x 1024: the counts and partials take
           the dense walk); each run's first loss against the single-device
           trainer's on the same batch (2e-3, the JAX package's bf16 SPMD
           pin), grad norm > 0, its launches (counts zeroed just before,
           read just after, summed over the ranks) and ms/step.  No rate of
           (b) is a multi-card number;
  times    each kernel and walk mode timed with CUDA events per layer,
           beside the plain version, the roofline bound of those inputs
           and the max error: the forward's CSR walk on the largest conv
           call the serve phase made, its dense walk on a full batch of
           four small-object scans (a direct forward of the served model,
           captured the same way), each forward also as its two kernels
           alone (the means walk and the product, the product's own rows
           against its plain version); dW and dX on the conv inputs of the
           train phase (CSR: segmentation, dense: classification) with g
           from a numpy seed, each also as its two kernels alone (dW's
           means walk and product, dX's sums walk and product, each
           product's own rows against its plain version).  Each product row
           has the ms of one PyTorch call of the same function beside it
           (``library_ms``; cuBLAS, never called by the port).
Then the ``kernels`` line (thirteen kernels), the nvidia-smi line and,
last, the result line.
Any failure raises: the script exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # f32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 tensor cores, dense
_PALLAS = "pointwise_tpu/kernels/pointwise_conv_pallas.py"
_CSRC = "pointwise_torch/kernels/csrc"
KERNELS = {     # name: (the TPU kernel it replaces, its source here)
    "fwd_dense": (f"{_PALLAS}:320", f"{_CSRC}/pointwise_conv_fwd.cu"),
    "fwd_csr": (f"{_PALLAS}:599", f"{_CSRC}/pointwise_conv_fwd.cu"),
    "fwd_product": (f"{_PALLAS}:297", f"{_CSRC}/pointwise_conv_product.cuh"),
    "dw_dense": (f"{_PALLAS}:396", f"{_CSRC}/pointwise_conv_dw.cu"),
    "dw_csr": (f"{_PALLAS}:636", f"{_CSRC}/pointwise_conv_dw.cu"),
    "dw_product": (f"{_PALLAS}:434", f"{_CSRC}/pointwise_conv_dw.cu"),
    "dx_dense": (f"{_PALLAS}:527", f"{_CSRC}/pointwise_conv_dx.cu"),
    "dx_csr": (f"{_PALLAS}:748", f"{_CSRC}/pointwise_conv_dx.cu"),
    "dx_product": (f"{_PALLAS}:476", f"{_CSRC}/pointwise_conv_product.cuh"),
    "counts_dense": (f"{_PALLAS}:1317", f"{_CSRC}/pointwise_conv_counts.cu"),
    "counts_csr": (f"{_PALLAS}:1317", f"{_CSRC}/pointwise_conv_counts.cu"),
    "fwd_ext_dense": (f"{_PALLAS}:1366", f"{_CSRC}/pointwise_conv_fwd.cu"),
    "fwd_ext_csr": (f"{_PALLAS}:1366", f"{_CSRC}/pointwise_conv_fwd.cu"),
}
# f32 operations per candidate a counts walk tests: 3 subtractions, 3
# multiplications and 2 additions for the squared distance, 1 comparison
COUNTS_OPS_PER_PAIR = 9
SPATIAL_STEPS = 3
SPMD_LOSS_RTOL = 2e-3
TRAIN_STEPS = 20
TRAIN_CONFIGS = (("s3dis_synthetic_local", "csr"),
                 ("modelnet40_synthetic", "dense"))


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
                    cnt_equal = bool(torch.equal(cnt, cnt_p))
                    if precision == "float32":   # geometry only: once
                        walk = (kw["ctr"], kw["pts"], kw["radius"],
                                kw["tile_ptr"], kw["tile_idx"])
                        counts = tk.conv_counts(*walk)
                        cnt_equal &= bool(torch.equal(counts, cnt)
                                          and torch.equal(
                                              counts,
                                              tk.conv_counts_plain(*walk)))
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err, ok = compare(y, y_p, precision)
                    cases.append(dict(p=p, cin=cin, radius=radius,
                                      walk="csr" if csr else "dense",
                                      precision=precision, max_abs_err=err,
                                      pairs=int(cnt.sum()),
                                      counts_equal=cnt_equal, ok=ok))
                    if not (ok and cnt_equal):
                        emit({"phase": "parity", "failed": cases[-1]})
                        raise AssertionError(f"kernel != plain: {cases[-1]}")
    emit({"phase": "parity", "ok": True, "cases": cases})


def compare_grad(x, x_ref, precision):
    """(max abs error, ok): f32 1e-4, bf16 2e-2, both relative to max
    |x_ref| (dW sums over every center, so its scale grows with B * N)."""
    err = float((x - x_ref).abs().max())
    tol = 1e-4 if precision == "float32" else 2e-2
    return err, err <= tol * float(x_ref.abs().max())


def grad_inputs(kw, seed, nc=None):
    """The forward's counts, a gradient g from a numpy seed (zero on the
    centers past ``nc``, the padding the op slices off) and the transposed
    tile list of the CSR walk: (dW args, dX args)."""
    import numpy as np
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    _, cnt = tk.conv_fwd(**kw)
    b, ncp, _ = kw["ctr"].shape
    g = np.random.RandomState(seed).standard_normal(
        (b, ncp, kw["w"].shape[2])).astype(np.float32)
    g[:, ncp if nc is None else nc:] = 0.0
    g = torch.from_numpy(g).to(cnt.device)
    ptr_t = idx_t = None
    if kw["tile_ptr"] is not None:
        ptr_t, idx_t = tk.tile_adjacency(kw["pts"], kw["ctr"], kw["radius"])
    return ((kw["ctr"], kw["pts"], kw["feats"], g, cnt, kw["radius"],
             kw["tile_ptr"], kw["tile_idx"]),
            (kw["ctr"], kw["pts"], g, cnt, kw["w"], kw["radius"], ptr_t,
             idx_t))


def phase_grad(dev, sizes=(4096, 8192), batch=4):
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops import pointwise_conv
    from pointwise_torch.ops.pointwise_conv import conv_layout

    cases = []
    for p in sizes:
        for cin, radius in ((6, 0.09375), (124, 0.375)):
            inp = parity_inputs(dev, batch, p, cin, 124, radius, seed=p + cin)
            for precision in ("float32", "bfloat16"):
                outs = {}
                for csr in (False, True):
                    kw, (_, nc, _) = conv_layout(
                        inp["points"], inp["features"], inp["weights"],
                        inp["bias"], radius=radius, mask=inp["mask"],
                        centers=inp["centers"],
                        center_mask=inp["center_mask"], precision=precision,
                        csr=csr)
                    dw_args, dx_args = grad_inputs(kw, seed=p + cin + 1,
                                                   nc=nc)
                    dw, dx = tk.conv_dw(*dw_args), tk.conv_dx(*dx_args)
                    again = (tk.conv_dw(*dw_args), tk.conv_dx(*dx_args))
                    dw_p = tk.conv_dw_plain(*dw_args)
                    dx_p = tk.conv_dx_plain(*dx_args)
                    torch.cuda.synchronize()
                    outs[csr] = (dw, dx)
                    rec = dict(p=p, cin=cin, radius=radius,
                               walk="csr" if csr else "dense",
                               precision=precision,
                               repeat_identical=bool(
                                   torch.equal(dw, again[0])
                                   and torch.equal(dx, again[1])))
                    for name, x, x_p in (("dw", dw, dw_p), ("dx", dx, dx_p)):
                        err, ok = compare_grad(x, x_p, precision)
                        rec[f"{name}_max_abs_err"] = err
                        rec[f"{name}_max_abs"] = float(x_p.abs().max())
                        rec[f"{name}_ok"] = ok
                    cases.append(rec)
                    if not (rec["dw_ok"] and rec["dx_ok"]
                            and rec["repeat_identical"]):
                        emit({"phase": "grad", "failed": rec})
                        raise AssertionError(f"grad kernel != plain: {rec}")
                same = all(torch.equal(a, b)
                           for a, b in zip(outs[False], outs[True]))
                cases[-1]["walks_identical"] = same
                if not same:
                    emit({"phase": "grad", "failed": cases[-1]})
                    raise AssertionError(f"dense != CSR bits: {cases[-1]}")
    # the backward of the public op runs the kernels
    inp = parity_inputs(dev, batch, 4096, 124, 124, 0.375, seed=7)
    tk.reset_launches()
    for csr in (False, True):
        f = inp["features"].clone().requires_grad_(True)
        w = inp["weights"].clone().requires_grad_(True)
        y = pointwise_conv(inp["points"], f, w, inp["bias"], radius=0.375,
                           mask=inp["mask"], precision="bfloat16", csr=csr)
        (y.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    if any(launches[k] != 1 for k in ("dw_dense", "dw_csr", "dx_dense",
                                      "dx_csr")) \
            or launches["dw_product"] != 2 or launches["dx_product"] != 2:
        raise AssertionError(f"backward did not launch the kernels: "
                             f"{launches}")
    emit({"phase": "grad", "ok": True, "cases": cases,
          "backward_launches": launches})


def phase_ext(dev, sizes=(4096, 8192), batch=4, radius=0.375):
    """The forward with external counts and dW / dX divided by them, on the
    parity phase's inputs (Cin = Cout = 124): the slab is the first half of
    the candidates, the counts are over all of them (the counts kernel)."""
    import numpy as np
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops.pointwise_conv import conv_layout

    fwd_cases, grad_cases = [], []
    for p in sizes:
        inp = parity_inputs(dev, batch, p, 124, 124, radius, seed=p + 124)
        n = inp["points"].shape[1]

        def layout(sl, precision, csr):
            return conv_layout(
                inp["points"][:, sl], inp["features"][:, sl],
                inp["weights"], None, radius=radius,
                mask=inp["mask"][:, sl], centers=inp["centers"],
                center_mask=inp["center_mask"], precision=precision,
                csr=csr)

        for csr in (False, True):
            for precision in ("float32", "bfloat16"):
                kw_all, (_, nc, _) = layout(slice(None), precision, csr)
                counts = tk.conv_counts(kw_all["ctr"], kw_all["pts"], radius,
                                        kw_all["tile_ptr"],
                                        kw_all["tile_idx"])
                want, _ = tk.conv_fwd(**kw_all)
                kw, _ = layout(slice(0, n // 2), precision, csr)
                y, own = tk.conv_fwd(**kw, cnt_in=counts)
                y_p, own_p = tk.conv_fwd_plain(**kw, cnt_in=counts)
                rec = dict(p=p, walk="csr" if csr else "dense",
                           precision=precision,
                           own_counts_equal=bool(torch.equal(own, own_p)))
                rec["max_abs_err"], rec["ok"] = compare(y, y_p, precision)
                for parts in (2, 4):
                    edges = np.linspace(0, n, parts + 1).astype(int)
                    total = None
                    for a, b in zip(edges[:-1], edges[1:]):
                        kw_s, _ = layout(slice(a, b), precision, csr)
                        ys, _ = tk.conv_fwd(**kw_s, cnt_in=counts)
                        total = ys if total is None else total + ys
                    err, ok = compare(total, want, precision)
                    rec[f"slabs{parts}_max_abs_err"] = err
                    rec["ok"] &= ok
                torch.cuda.synchronize()
                fwd_cases.append(rec)
                if not (rec["ok"] and rec["own_counts_equal"]):
                    emit({"phase": "parity", "failed": rec})
                    raise AssertionError(f"ext forward failed: {rec}")
                # dW and dX take the external counts as their divisor
                dw_args, dx_args = grad_inputs(kw, seed=p + 5, nc=nc)
                dw_args = dw_args[:4] + (counts,) + dw_args[5:]
                dx_args = dx_args[:3] + (counts,) + dx_args[4:]
                dw, dx = tk.conv_dw(*dw_args), tk.conv_dx(*dx_args)
                again = (tk.conv_dw(*dw_args), tk.conv_dx(*dx_args))
                dw_p, dx_p = tk.conv_dw_plain(*dw_args), tk.conv_dx_plain(
                    *dx_args)
                torch.cuda.synchronize()
                g = dict(p=p, walk=rec["walk"], precision=precision,
                         repeat_identical=bool(torch.equal(dw, again[0])
                                               and torch.equal(dx, again[1])))
                for name, x, x_p in (("dw", dw, dw_p), ("dx", dx, dx_p)):
                    g[f"{name}_max_abs_err"], g[f"{name}_ok"] = compare_grad(
                        x, x_p, precision)
                grad_cases.append(g)
                if not (g["dw_ok"] and g["dx_ok"] and g["repeat_identical"]):
                    emit({"phase": "grad", "failed": g})
                    raise AssertionError(f"ext-counts grads failed: {g}")
    emit({"phase": "parity", "ok": True, "ext_counts": fwd_cases})
    emit({"phase": "grad", "ok": True, "ext_counts": grad_cases})


class ConvRecorder:
    """A global forward hook on every PointwiseConv that runs (the train CLI
    builds its own model): keeps, per (kernel family and walk, layer), the
    inputs of the largest call, so the times phase runs the kernels at the
    shapes the main path gave them, and counts what the backward of each
    call launches.  A conv's layer is told by its radius (``radii``);
    ``prefix`` is the family its calls are filed under ("fwd", "dw")."""

    def __init__(self, radii, prefix="fwd"):
        import torch

        from pointwise_torch.models.layers import PointwiseConv
        from pointwise_torch.ops.pointwise_conv import csr_walk

        self.calls = {}
        self.backward_calls = collections.Counter()

        def hook(mod, args, out):
            if not isinstance(mod, PointwiseConv):
                return
            layer = list(radii).index(mod.radius)
            points, x, mask, centers, center_mask = (
                list(args) + [None] * 5)[:5]
            walk = "csr" if csr_walk(points.shape[1]) else "dense"
            if torch.is_grad_enabled():
                # what the backward of this call launches
                self.backward_calls[(f"dw_{walk}", layer)] += int(
                    mod.kernel.requires_grad)
                self.backward_calls[(f"dx_{walk}", layer)] += int(
                    x.requires_grad)
            nc = (points if centers is None else centers).shape[1]
            size = points.shape[0] * points.shape[1] * nc
            key = (f"{prefix}_{walk}", layer)
            if size > self.calls.get(key, (0,))[0]:
                self.calls[key] = (size, mod, tuple(
                    None if a is None else a.detach()
                    for a in (points, x, mask, centers, center_mask)))

        self.handle = torch.nn.modules.module.register_module_forward_hook(
            hook)

    def remove(self):
        self.handle.remove()


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
    recorder = ConvRecorder(cfg.radii)
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
    if min(launches["fwd_dense"], launches["fwd_csr"]) <= 0:
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
    recorder = ConvRecorder(cfg.radii)
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


def device_busy_s(prof):
    """(seconds of device time in a torch.profiler run, 0 if it saw none;
    the device ops; their self device time in us, as a function)."""
    import torch

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(dev_us(e) for e in ops) / 1e6, ops, dev_us


# device-time families of the traces: (name, substring of the kernel name)
KERNEL_FAMILIES = (("fwd_walk", "FwdMeans"), ("fwd_product", "FwdProduct"),
                   ("dw_walk", "DwMeans"), ("dw_product", "pw_dw_product"),
                   ("dw_reduce", "pw_dw_reduce"), ("dx_walk", "DxSums"),
                   ("dx_product", "DxProduct"),
                   ("counts", "pw_counts_kernel"))


def kernel_ms(ops, dev_us, per=1):
    """Device ms of each kernel family in a trace's ops, over ``per``
    (steps or requests); a walk family includes its feature-pack kernel
    (and dX's its scale kernel), dW's product its g-rounding kernel."""
    return {fam: sum(dev_us(e) for e in ops if key in e.key) / 1e3 / per
            for fam, key in KERNEL_FAMILIES}


def phase_train(dev, workdir, steps=TRAIN_STEPS, traced=(18, 19)):
    """Both configurations through the train CLI's function; returns
    ({config: summary}, {(kernel_walk, layer): recorded conv call},
    {(kernel_walk, layer): dW / dX launches per training step}, the
    segmentation checkpoint directory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.train import cli, get_config

    summaries, calls, per_step = {}, {}, {}
    for config, walk in TRAIN_CONFIGS:
        cfg = get_config(config)
        ck = os.path.join(workdir, config)
        marks, metrics, prof = {}, [], []

        def on_step(step, m):
            # device-synchronised wall clock after every step; steps
            # traced[0]..traced[1] run under the profiler
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
            metrics.append({k: float(v) for k, v in m.items()})
            if step == traced[0] - 1:
                prof.append(profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]))
                prof[0].__enter__()
            elif step == traced[1]:
                prof[0].__exit__(None, None, None)

        recorder = ConvRecorder(cfg.radii, prefix="dw")
        tk.reset_launches()
        trainer = cli.main(["--config", config, "--steps", str(steps),
                            "--device", dev.type, "--checkpoint-dir", ck],
                           on_step=on_step)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        recorder.remove()
        initial, _ = (cli.build_segmenter if walk == "csr"
                      else cli.build_classifier)(cfg, dev)
        final = trainer.model.state_dict()
        changed = any(not torch.equal(a, b) for a, b in zip(
            final.values(), initial.state_dict().values()))
        # the same seed, stopped half way and resumed from its checkpoint,
        # must end on the same bits (every reduction runs in a fixed order)
        common = ["--config", config, "--device", dev.type,
                  "--checkpoint-dir", os.path.join(workdir, f"{config}_2")]
        cli.main(common + ["--steps", str(steps // 2)])
        resumed = cli.main(common + ["--steps", str(steps), "--resume"])
        repeat = all(torch.equal(a, b) for a, b in zip(
            final.values(), resumed.model.state_dict().values()))
        step_s = (marks[steps] - marks[2]) / (steps - 2)
        wall = marks[traced[1]] - marks[traced[0] - 1]
        busy, ops, dev_us = device_busy_s(prof[0])
        rec = dict(config=config, walk=walk, steps=steps,
                   batch=cfg.batch_size, points=cfg.num_points,
                   launches=launches, weights_changed=changed,
                   resumed_run_bitwise_equal=repeat,
                   ms_per_step=step_s * 1e3,
                   trained_points_per_s=cfg.batch_size * cfg.num_points
                   / step_s,
                   loss_first=metrics[0]["loss"], loss_last=metrics[-1]["loss"],
                   grad_norm_min=min(m["grad_norm"] for m in metrics),
                   traced_steps=list(traced), traced_wall_s=wall,
                   device_busy_s=busy if busy > 0 else "not measured")
        if busy > 0:
            rec["device_idle_share"] = 1.0 - busy / wall
            rec["kernel_ms_per_step"] = kernel_ms(
                ops, dev_us, per=traced[1] - traced[0] + 1)
            rec["top"] = [{"op": e.key[:80], "ms": dev_us(e) / 1e3,
                           "calls": e.count}
                          for e in sorted(ops, key=dev_us, reverse=True)[:6]]
        emit({"phase": "train", **rec})
        finite = all(math.isfinite(m["loss"]) for m in metrics)
        need = [f"dw_{walk}", f"dx_{walk}"]
        per_layer = {k: sum(v for (n, _), v in
                            recorder.backward_calls.items() if n == k)
                     for k in need}
        if not (finite and rec["grad_norm_min"] > 0 and changed and repeat
                and len(metrics) == steps
                and all(launches[k] > 0 for k in need)
                and all(per_layer[k] == launches[k] for k in need)
                # one product per walk
                and launches["dw_product"] == launches[need[0]]
                and launches["dx_product"] == launches[need[1]]):
            raise AssertionError(f"training failed: {rec}, hooks saw "
                                 f"{per_layer}")
        summaries[config] = rec
        calls.update(recorder.calls)
        per_step.update({k: v / steps
                         for k, v in recorder.backward_calls.items()})
    return (summaries, calls, per_step,
            os.path.join(workdir, TRAIN_CONFIGS[0][0]))


def phase_serve_trained(dev, ck, n_points=200_000):
    """infer --checkpoint-dir: the trained segmenter answers one request."""
    from pointwise_torch import infer
    from pointwise_torch.train import get_config

    config = TRAIN_CONFIGS[0][0]
    args = infer.parse_args(["--serve", "--config", config, "--device",
                             dev.type, "--checkpoint-dir", ck,
                             "--warm-points", "0"])
    cfg = get_config(config)
    model = infer.build_model(cfg, dev, checkpoint_dir=ck)
    replies = []
    infer.serve(args, cfg, model, requests=[f"synth:{n_points}"],
                emit=replies.append)
    emit({"phase": "train", "served_from_checkpoint": replies})
    if len(replies) != 2 or "error" in replies[1] \
            or not replies[1]["pts_per_s"] > 0:
        raise AssertionError(f"serving the trained checkpoint failed: "
                             f"{replies}")


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
    busy, dev_ops, dev_us = device_busy_s(prof)
    rec = {"phase": "trace", "n_points": len(xyz), "wall_s": wall}
    if busy <= 0:
        rec["device_busy_s"] = "not measured"
    else:
        rec.update(device_busy_s=busy, device_idle_share=1.0 - busy / wall,
                   kernel_ms=kernel_ms(dev_ops, dev_us),
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


def spatial_configs():
    """The spatial phase's configurations: the training cells at dropout 0
    (and segmentation jitter 0, ``jitter=0.0`` of the CLI's function), so
    that a sharded step computes the unsharded one's function."""
    import dataclasses

    from pointwise_torch.train import get_config

    return (dataclasses.replace(get_config("s3dis_synthetic_local"),
                                dropout=0.0),
            dataclasses.replace(get_config("modelnet40_synthetic"),
                                dropout=0.0))


def spatial_batches(cfg, n):
    """The first ``n`` training batches of the train CLI's epoch 0."""
    import itertools

    from pointwise_torch.data import modelnet, s3dis
    from pointwise_torch.train.configs import ClassificationConfig

    if isinstance(cfg, ClassificationConfig):
        data = modelnet.load_modelnet40(None, "train", cfg.num_points,
                                        seed=cfg.seed, variant=cfg.variant)
        it = modelnet.batches(data, cfg.batch_size, seed=cfg.seed)
    else:
        rooms = s3dis.load_rooms(None, seed=cfg.seed)
        blocks = s3dis.training_blocks(
            cfg, rooms=rooms[max(1, len(rooms) // 10):])
        it = s3dis.block_batches(blocks, cfg.batch_size, seed=cfg.seed)
    return list(itertools.islice(it, n))


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def spatial_worker(mesh, steps, configs):
    """One rank of the spatial phase's 2-rank runs (spawned by
    pointwise_torch.parallel.launch, which imports this module): the
    gather strategy through the train CLI's function (--sp 2), then the
    ring for the segmenter and for the classifier through the Trainer.
    Returns, per run, the launches, the step metrics and ms/step."""
    import contextlib
    import io

    from pointwise_torch.data import augment, pipeline
    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.models import PointwiseClassifier, PointwiseSegmenter
    from pointwise_torch.parallel.spmd import cls_spmd_loss_fn, seg_spmd_loss_fn
    from pointwise_torch.train import cli
    from pointwise_torch.train.trainer import Trainer, step_seed

    dev = mesh.device
    seg, cls = configs
    if dev.type == "cuda":
        tk.build_libraries()
    out = {}

    def run(name, go):
        marks, metrics = [], []

        def on_step(step, m):
            sync(dev)
            marks.append(time.perf_counter())
            metrics.append({k: float(v) for k, v in m.items()})

        sync(dev)
        tk.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):   # rank 0's JSONL
            go(on_step)
        sync(dev)
        out[name] = dict(launches=dict(tk.LAUNCHES), metrics=metrics,
                         ms_per_step=(marks[-1] - marks[0])
                         / (len(marks) - 1) * 1e3)

    def trained(cfg, model, loss_fn, on_step, **spmd):
        trainer = Trainer(model.to(dev), loss_fn, cfg.optimizer, mesh=mesh,
                          space_axis="space", **spmd)
        for step, batch in enumerate(spatial_batches(cfg, steps)):
            on_step(step + 1, trainer.step(pipeline.to_device(batch, dev),
                                           step_seed(cfg.seed, step)))

    args = cli.parse_args(["--config", seg.name, "--steps", str(steps),
                           "--sp", "2", "--device", dev.type])
    run("gather", lambda on_step: cli.train_segmentation(
        seg, args, dev, on_step, mesh, jitter=0.0))
    run("seg_ring", lambda on_step: trained(seg, PointwiseSegmenter(
        num_classes=seg.num_classes, in_features=seg.in_features,
        channels=seg.channels, radii=seg.radii, head_dims=seg.head_dims,
        dropout_rate=0.0, impl="spatial:space:ring",
        use_global_context=seg.global_context, mesh=mesh,
        generator=cli._init_generator(seg)), seg_spmd_loss_fn(), on_step))
    run("cls_ring", lambda on_step: trained(cls, PointwiseClassifier(
        num_classes=cls.num_classes, channels=cls.channels, radii=cls.radii,
        head_dims=cls.head_dims, dropout_rate=0.0,
        impl="spatial:space:ring", context_axes=("space",), mesh=mesh,
        generator=cli._init_generator(cls)), cls_spmd_loss_fn(), on_step,
        rng_axes=("data",), global_augment=lambda b, g: dict(
            b, points=augment.classification_augment(
                b["points"], g, rotate=cls.rotate_augment))))
    return out


def phase_spatial_served(dev, call, slabs=4):
    """(a) The ring's arithmetic on one process at the served scale: the
    largest served CSR call split into ``slabs`` candidate slabs.  Returns
    the launches and the kernel-level inputs of its counts call and first
    partial (for the kernels line)."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops import pointwise_conv, pointwise_conv_counts
    from pointwise_torch.ops.pointwise_conv import conv_layout, pad_counts

    _, mod, (points, x, mask, centers, center_mask) = call
    r, prec = mod.radius, mod.precision
    geo = dict(radius=r, centers=centers, center_mask=center_mask)
    cuts = torch.arange(points.shape[1]).tensor_split(slabs)
    with torch.inference_mode():
        torch.cuda.synchronize()
        tk.reset_launches()
        counts = pointwise_conv_counts(points, mask=mask, **geo)
        total = None
        for c in cuts:
            sl = slice(int(c[0]), int(c[-1]) + 1)
            part = pointwise_conv(points[:, sl], x[:, sl], mod.kernel, None,
                                  mask=mask[:, sl], precision=prec,
                                  ext_counts=counts, **geo).float()
            total = part if total is None else total + part
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        full = pointwise_conv(points, x, mod.kernel, None, mask=mask,
                              precision=prec, **geo).float()
        err, ok = compare(total, full, prec)
        kw_all, _ = conv_layout(points, x, mod.kernel, None, mask=mask,
                                precision=prec, **geo)
        cnt_in = pad_counts(counts, kw_all["ctr"].shape[1])
        walk = (kw_all["ctr"], kw_all["pts"], r, kw_all["tile_ptr"],
                kw_all["tile_idx"])
        counts_ms = cuda_time_ms(lambda: tk.conv_counts(*walk), reps=5)
        fwd_ms = cuda_time_ms(lambda: tk.conv_fwd(**kw_all), reps=5)
        parts = []
        for c in cuts:
            sl = slice(int(c[0]), int(c[-1]) + 1)
            kw, _ = conv_layout(points[:, sl], x[:, sl], mod.kernel, None,
                                mask=mask[:, sl], precision=prec, **geo)
            parts.append(kw)
        part_ms = [cuda_time_ms(lambda: tk.conv_fwd(**kw, cnt_in=cnt_in),
                                reps=5) for kw in parts]
    rec = dict(candidates=int(points.shape[1]), centers=int(centers.shape[1]),
               cin=int(x.shape[2]), precision=prec, radius=r, slabs=slabs,
               launches=launches, max_abs_err=err,
               max_abs_y=float(full.abs().max()), ok=ok, counts_ms=counts_ms,
               partial_ms=part_ms, partials_total_ms=sum(part_ms),
               forward_ms=fwd_ms)
    emit({"phase": "spatial", "served_split": rec})
    if not (ok and launches["counts_csr"] == 1
            and launches["fwd_ext_csr"] == slabs):
        raise AssertionError(f"served-scale ring split failed: {rec}")
    return launches, (mod, parts[0], cnt_in, center_mask)


def phase_spatial_ranks(dev, workdir, configs=None, steps=SPATIAL_STEPS):
    """(b) 2 ranks on cuda:0 over gloo against the single-device trainer.
    Returns the summed launches of the three runs and the recorded conv
    calls of the single-device runs (their shapes time the ring's
    kernels)."""
    import contextlib
    import functools
    import io

    from pointwise_torch.parallel import launch
    from pointwise_torch.train import cli

    seg, cls = configs or spatial_configs()
    single, calls = {}, {}
    for cfg, train in ((seg, functools.partial(cli.train_segmentation,
                                               jitter=0.0)),
                       (cls, cli.train_classification)):
        first = []
        recorder = ConvRecorder(cfg.radii, prefix="ring")
        args = cli.parse_args(["--config", cfg.name, "--steps", "1",
                               "--device", dev.type])
        with contextlib.redirect_stdout(io.StringIO()):   # its JSONL
            train(cfg, args, dev,
                  lambda step, m: first.append(float(m["loss"])))
        recorder.remove()
        single[cfg.name] = first[0]
        calls[cfg.name] = recorder.calls
    sync(dev)
    t0 = time.perf_counter()
    res = launch.spawn(spatial_worker, 2, os.path.join(workdir, "ranks"),
                       data=1, space=2, backend="gloo",
                       device="cuda:0" if dev.type == "cuda" else "cpu",
                       kwargs=dict(steps=steps, configs=(seg, cls)),
                       timeout=900, comm_timeout=300, threads=4)
    wall = time.perf_counter() - t0
    launches = collections.Counter()
    for name, cfg, need in (
            ("gather", seg, ("fwd_csr", "dw_csr", "dx_csr", "dw_product",
                             "dx_product")),
            ("seg_ring", seg, ("counts_csr", "fwd_ext_dense", "dw_dense",
                               "dx_dense", "dw_product", "dx_product")),
            ("cls_ring", cls, ("counts_dense", "fwd_ext_dense", "dw_dense",
                               "dx_dense", "dw_product", "dx_product"))):
        runs = [r[name] for r in res]
        got = collections.Counter()
        for r in runs:
            got.update(r["launches"])
        first = runs[0]["metrics"][0]["loss"]
        rel = abs(first - single[cfg.name]) / abs(single[cfg.name])
        rec = dict(run=name, config=cfg.name, ranks=2, steps=steps,
                   launches={k: v for k, v in got.items() if v},
                   loss_first=first, loss_first_single_device=single[cfg.name],
                   loss_rel_diff=rel, tol=SPMD_LOSS_RTOL,
                   loss_last=runs[0]["metrics"][-1]["loss"],
                   grad_norm_min=min(m["grad_norm"] for r in runs
                                     for m in r["metrics"]),
                   ms_per_step=[r["ms_per_step"] for r in runs],
                   communication="gloo, host-staged, 2 ranks sharing one card "
                                 "(not a multi-card rate)")
        emit({"phase": "spatial", **rec})
        same = all(r["metrics"] == runs[0]["metrics"] for r in runs)
        if not (rel <= SPMD_LOSS_RTOL and rec["grad_norm_min"] > 0 and same
                and all(got[k] > 0 for k in need)
                and all(math.isfinite(m["loss"]) for m in runs[0]["metrics"])):
            raise AssertionError(f"spatial run {name} failed: {rec}")
        launches.update(got)
    emit({"phase": "spatial", "ranks_wall_s": wall})
    return launches, calls


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


def bound(inputs, outputs, pairs, pair_width, rows, cin, cout, bf16):
    """Least time (ms) the card needs for one call, the larger of two: the
    bytes moved (each input read once, each output written once; of a
    CSR tile list only its offsets and the indices it holds) over HBM
    bandwidth, and the work these inputs need over the peak rate of its
    type.  The work is two parts that one unit runs in turn, so they add:
    ``pair_width`` adds per in-ball pair (Cin for the forward and dW, Cout
    for dX) and the (27*Cin) x Cout product of ``rows`` real rows (two
    operations per multiply-add), both at the peak rate of the matmul type
    (tensor cores in bf16, the CUDA cores' f32 rate in f32).  Returns (ms,
    "bytes" or "operations", bytes)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs
                 if t is not None)
    t_ops = (pairs * pair_width + 2.0 * 27 * cin * cout * rows) / (
        BF16_FLOPS if bf16 else F32_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def _real_rows(points, mask, nc, cmask):
    """(real centers, real candidates) of one recorded conv call."""
    centers = points.shape[0] * nc if cmask is None else float(cmask.sum())
    cands = (points.shape[0] * points.shape[1] if mask is None
             else float(mask.sum()))
    return centers, cands


def _shape(kw):
    return dict(B=int(kw["pts"].shape[0]), Mp=int(kw["pts"].shape[1]),
                Ncp=int(kw["ctr"].shape[1]), cin=int(kw["w"].shape[1]),
                cout=int(kw["w"].shape[2]))


def library_product(xbar, w, bias):
    """The forward's product as one cuBLAS call: y = xbar . W + bias with
    the operands in their own type and an f32 result (bf16 products
    accumulate in f32, as in the kernel).  Timed beside the kernel only;
    the port never calls it.  Returns (a call with no arguments, its
    name)."""
    import torch

    wk = w.reshape(-1, w.shape[2])
    if xbar.dtype != torch.bfloat16:
        return (lambda: torch.addmm(bias, xbar, wk)), "addmm"
    try:
        torch.addmm(bias, xbar, wk, out_dtype=torch.float32)
        return ((lambda: torch.addmm(bias, xbar, wk,
                                     out_dtype=torch.float32)),
                "addmm(out_dtype=float32)")
    except (RuntimeError, TypeError):
        # this torch's addmm takes no f32 bias beside bf16 operands
        return ((lambda: torch.mm(xbar, wk, out_dtype=torch.float32) + bias),
                "mm(out_dtype=float32) + bias")


def _mm_f32(a, b):
    """One cuBLAS product a . b with an f32 result (bf16 operands accumulate
    in f32, as in the kernels): (a call with no arguments, its name)."""
    import torch

    if a.dtype != torch.bfloat16:
        return (lambda: torch.mm(a, b)), "mm"
    try:
        torch.mm(a, b, out_dtype=torch.float32)
        return ((lambda: torch.mm(a, b, out_dtype=torch.float32)),
                "mm(out_dtype=float32)")
    except (RuntimeError, TypeError):
        # this torch's mm takes no out_dtype: the same function in f32
        af, bf = a.float(), b.float()
        return (lambda: torch.mm(af, bf)), "mm of the operands in float32"


def library_dw_product(xbar, g):
    """dW's product as one cuBLAS call, xbar^T . round(g) with an f32
    result; g is rounded before the timed call.  Timed beside the kernel
    only; the port never calls it."""
    call, name = _mm_f32(xbar.T, g.to(xbar.dtype))
    shape = (27, xbar.shape[1] // 27, g.shape[1])
    return (lambda: call().view(shape)), name


def library_dx_product(z, w):
    """dX's product as one cuBLAS call, Z . W^T per cell with an f32
    result; W^T is laid out before the timed call.  Timed beside the kernel
    only; the port never calls it."""
    return _mm_f32(z, w.transpose(1, 2).reshape(-1, w.shape[1]))


def _time_row(name, layer, mod, kw, fn, plain, args, inputs, pairs, width,
              rows, library=None, **extra):
    """One kernel call at a recorded shape: its output against the plain
    version's, CUDA-event ms (5 launches after one warm-up), the plain
    version's ms (one call), the bound and, where ``library`` (see
    ``library_product``) is given, the ms of its PyTorch call of the same
    function (5 calls after one warm-up) and its error against the plain
    version."""
    import torch

    out, ref = fn(*args), plain(*args)
    first = (lambda o: o[0]) if isinstance(out, tuple) else (lambda o: o)
    err, ok = (compare if name.startswith("fwd") else compare_grad)(
        first(out), first(ref), mod.precision)
    ms = cuda_time_ms(lambda: fn(*args), reps=5)
    plain_ms = cuda_time_ms(lambda: plain(*args), reps=1, warmup=0)
    if library is not None:
        call, extra["library_call"] = library(*args)
        extra["library_err"], _ = compare(call(), first(ref), mod.precision)
        extra["library_ms"] = cuda_time_ms(call, reps=5)
    cin, cout = kw["w"].shape[1], kw["w"].shape[2]
    bound_ms, bound_by, nbytes = bound(
        inputs, list(out) if isinstance(out, tuple) else [out], pairs, width,
        rows, cin, cout, kw["feats"].dtype == torch.bfloat16)
    row = dict(name=name, layer=layer, radius=mod.radius, shape=_shape(kw),
               precision=mod.precision, pairs=pairs, bytes=nbytes, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               max_abs_err=err, ok=ok, **extra)
    emit({"phase": "times", **row})
    if not ok:
        raise AssertionError(f"kernel != plain at the main path's shape: "
                             f"{row}")
    return row


def phase_times(calls, per_step):
    """Forward rows from the serve phase's calls; dW and dX rows from the
    train phase's (keys "dw_<walk>"), with g from a numpy seed and the
    launches per training step of each (kernel, layer)."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops.pointwise_conv import conv_layout

    rows = []
    for (name, layer), (_, mod, args) in sorted(calls.items()):
        points, x, mask, centers, center_mask = args
        walk = name.split("_")[1]
        with torch.inference_mode():
            kw, (_, nc, cmask) = conv_layout(
                points, x, mod.kernel, mod.bias, radius=mod.radius,
                mask=mask, centers=centers, center_mask=center_mask,
                precision=mod.precision)
            if (kw["tile_idx"] is not None) != (walk == "csr"):
                raise AssertionError("walk mode changed between runs")
            centers_n, cands_n = _real_rows(points, mask, nc, cmask)
            cin, cout = kw["w"].shape[1], kw["w"].shape[2]
            lists = [kw["tile_ptr"], kw["tile_idx"]]
            if name.startswith("fwd"):
                fa = tuple(kw[k] for k in ("ctr", "pts", "feats", "w", "bias",
                                           "radius", "tile_ptr", "tile_idx"))
                pairs = float(tk.conv_fwd(*fa)[1].sum())
                # the wrapper's two kernels, each alone
                means = fa[:3] + fa[5:]
                xbar, _ = tk.conv_fwd_means(*means)
                pa = (xbar, kw["w"], kw["bias"])
                split = dict(
                    walk_ms=cuda_time_ms(lambda: tk.conv_fwd_means(*means),
                                         reps=5),
                    product_ms=cuda_time_ms(
                        lambda: tk.conv_fwd_product(*pa), reps=5))
                rows.append(_time_row(name, layer, mod, kw, tk.conv_fwd,
                                      tk.conv_fwd_plain, fa,
                                      list(fa[:5]) + lists, pairs, cin,
                                      centers_n, **split))
                rows.append(_time_row("fwd_product", layer, mod, kw,
                                      tk.conv_fwd_product,
                                      tk.conv_fwd_product_plain, pa,
                                      list(pa), 0.0, 0, centers_n,
                                      library=library_product, walk=walk))
                continue
            dw_args, dx_args = grad_inputs(kw, seed=layer, nc=nc)
            pairs = float(dw_args[4].sum())
            ctr, pts, feats, g, cnt, radius, ptr, idx = dw_args
            w, ptr_t, idx_t = dx_args[4], dx_args[6], dx_args[7]
            # each gradient's two kernels, each alone
            means = (ctr, pts, feats, cnt, radius, ptr, idx)
            sums = (ctr, pts, g, cnt, radius, ptr_t, idx_t, w.dtype)
            xbar, z = tk.conv_dw_means(*means), tk.conv_dx_sums(*sums)
            g2 = g.view(-1, cout)
            splits = {
                "dw": dict(walk_ms=cuda_time_ms(
                    lambda: tk.conv_dw_means(*means), reps=5),
                    product_ms=cuda_time_ms(
                        lambda: tk.conv_dw_product(xbar, g2), reps=5)),
                "dx": dict(walk_ms=cuda_time_ms(
                    lambda: tk.conv_dx_sums(*sums), reps=5),
                    product_ms=cuda_time_ms(
                        lambda: tk.conv_dx_product(z, w), reps=5))}
            for kname, fn, plain, a, ins, width, n in (
                    (f"dw_{walk}", tk.conv_dw, tk.conv_dw_plain, dw_args,
                     list(dw_args[:5]) + lists, cin, centers_n),
                    (f"dx_{walk}", tk.conv_dx, tk.conv_dx_plain, dx_args,
                     list(dx_args[:5]) + list(dx_args[6:]), cout, cands_n)):
                per = per_step.get((kname, layer), 0.0)
                rows.append(_time_row(
                    kname, layer, mod, kw, fn, plain, a, ins, pairs, width, n,
                    launches_per_step=per, **splits[kname[:2]]))
            for kname, fn, plain, a, n, lib, walk_name in (
                    ("dw_product", tk.conv_dw_product,
                     tk.conv_dw_product_plain, (xbar, g2), centers_n,
                     library_dw_product, f"dw_{walk}"),
                    ("dx_product", tk.conv_dx_product,
                     tk.conv_dx_product_plain, (z, w), cands_n,
                     library_dx_product, f"dx_{walk}")):
                rows.append(_time_row(
                    kname, layer, mod, kw, fn, plain, a, list(a), 0.0, 0, n,
                    library=lib, walk=walk,
                    launches_per_step=per_step.get((walk_name, layer), 0.0)))
    return rows


def counts_row(name, layer, radius, walk):
    """The counts kernel at one main-path shape: equal to its plain
    version, CUDA-event ms (5 launches after one warm-up), the plain
    version's ms (one call) and the bound: the coordinates, the tile list
    and the counts moved once, against the walk's tested pairs at
    ``COUNTS_OPS_PER_PAIR`` f32 operations each."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    ctr, pts, _, ptr, idx = walk
    out, ref = tk.conv_counts(*walk), tk.conv_counts_plain(*walk)
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda: tk.conv_counts(*walk), reps=5)
    plain_ms = cuda_time_ms(lambda: tk.conv_counts_plain(*walk), reps=1,
                            warmup=0)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (ctr, pts, ptr, idx, out) if t is not None)
    tested = (ctr.shape[0] * ctr.shape[1] * pts.shape[1] if idx is None
              else idx.numel() * tk.TILE * tk.TILE)
    t_ops = tested * COUNTS_OPS_PER_PAIR / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    row = dict(name=name, layer=layer, radius=radius,
               shape=dict(B=int(ctr.shape[0]), Mp=int(pts.shape[1]),
                          Ncp=int(ctr.shape[1]), cin=0, cout=27),
               precision="float32", pairs=float(out.sum()),
               tested_pairs=tested, bytes=nbytes, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=float((out - ref).abs().max()),
               ok=bool(torch.equal(out, ref)))
    emit({"phase": "times", **row})
    if not row["ok"]:
        raise AssertionError(f"counts kernel != plain: {row}")
    return row


def ext_row(name, layer, mod, kw, cnt_in, center_mask):
    """The forward with external counts at one main-path shape
    (``_time_row``; the counts are an input it reads)."""
    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    fa = tuple(kw[k] for k in ("ctr", "pts", "feats", "w", "bias", "radius",
                               "tile_ptr", "tile_idx")) + (cnt_in,)
    pairs = float(tk.conv_fwd(*fa)[1].sum())
    centers = (kw["ctr"].shape[0] * kw["ctr"].shape[1]
               if center_mask is None else float(center_mask.sum()))
    return _time_row(name, layer, mod, kw, tk.conv_fwd, tk.conv_fwd_plain,
                     fa, list(fa[:5]) + list(fa[6:]), pairs,
                     kw["w"].shape[1], centers)


def spatial_rows(served_part, ring_calls):
    """Rows of the counts kernel and the external-counts forward at the
    shapes the spatial phase gave them: the seg ring's counts over 8 x 4096
    candidates for rank 0's 2048 centers (CSR) and its partial over rank
    1's slab (dense), the classifier ring's counts over 32 x 1024 for 512
    centers (dense), all at layer 3; the served split's first partial."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.ops.pointwise_conv import conv_layout, pad_counts

    rows = [ext_row("fwd_ext_csr", 3, *served_part)]
    with torch.inference_mode():
        for config, kname, ext in (("s3dis_synthetic_local", "counts_csr",
                                    True),
                                   ("modelnet40_synthetic", "counts_dense",
                                    False)):
            layer = max(k[1] for k in ring_calls[config])
            _, mod, (points, x, mask, _, _) = max(
                (v for k, v in ring_calls[config].items() if k[1] == layer),
                key=lambda v: v[0])
            half = points.shape[1] // 2
            cmask = None if mask is None else mask[:, :half]
            kw_all, _ = conv_layout(points, x, mod.kernel, None,
                                    radius=mod.radius, mask=mask,
                                    centers=points[:, :half],
                                    center_mask=cmask,
                                    precision=mod.precision)
            walk = (kw_all["ctr"], kw_all["pts"], mod.radius,
                    kw_all["tile_ptr"], kw_all["tile_idx"])
            row = counts_row(kname, layer, mod.radius, walk)
            if (walk[3] is None) != (kname == "counts_dense"):
                raise AssertionError(f"{kname} took the other walk")
            rows.append(row)
            if ext:
                kw, _ = conv_layout(points[:, half:], x[:, half:], mod.kernel,
                                    None, radius=mod.radius,
                                    mask=None if mask is None
                                    else mask[:, half:],
                                    centers=points[:, :half],
                                    center_mask=cmask,
                                    precision=mod.precision)
                if kw["tile_idx"] is not None:
                    raise AssertionError("the ring's slab took the CSR walk")
                counts = pad_counts(tk.conv_counts(*walk), kw["ctr"].shape[1])
                rows.append(ext_row("fwd_ext_dense", layer, mod, kw, counts,
                                    cmask))
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
    phase_grad(dev)
    phase_ext(dev)
    os.makedirs(tk._BUILD_DIR, exist_ok=True)     # ignored by git
    with tempfile.TemporaryDirectory(dir=tk._BUILD_DIR) as workdir:
        launches, _, served, model = phase_serve(dev, workdir)
        trained, train_calls, per_step, seg_ck = phase_train(dev,
                                                             workdir)
        phase_serve_trained(dev, seg_ck)
    # each kernel's launches come from its own path: the forward's from the
    # serve phase, dW's and dX's from the training run of their walk
    for rec in trained.values():
        for k in ("dw", "dx"):
            name = f"{k}_{rec['walk']}"
            launches[name] = rec["launches"][name]
    for name in ("dw_product", "dx_product"):    # both training runs
        launches[name] = sum(rec["launches"][name] for rec in trained.values())
    phase_trace(dev)
    phase_exact(dev)
    # the ring's launches: the served-scale split (a) for the CSR walk of
    # the external-counts forward, the 2-rank runs (b) for the rest
    ext_launches, served_part = phase_spatial_served(dev,
                                                     served[("fwd_csr", 3)])
    launches["fwd_ext_csr"] = ext_launches["fwd_ext_csr"]
    with tempfile.TemporaryDirectory(dir=tk._BUILD_DIR) as workdir:
        ring_launches, ring_calls = phase_spatial_ranks(dev, workdir)
    for k in ("counts_dense", "counts_csr", "fwd_ext_dense"):
        launches[k] = ring_launches[k]
    calls = {k: v for k, v in served.items() if k[0] == "fwd_csr"}
    calls.update(dense_calls(dev, model))
    calls.update(train_calls)
    rows = phase_times(calls, per_step)
    rows += spatial_rows(served_part, ring_calls)
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        top = max(mine, key=lambda r: r["ms"])    # the costliest layer
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"), "shape": top["shape"],
            "layer": top["layer"], "precision": top["precision"],
            **{k: top[k] for k in ("walk_ms", "product_ms", "walk",
                                   "library_call") if k in top}})
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
