#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py          # one card; every phase runs, always

Phases, each printing one JSON line:
  device   the card's name, count and power limit (nvidia-smi);
  build    nvcc builds the forward, dW, dX and counts kernels from
           kernels/csrc/ (first use; one nvcc per source, all started
           together); the line gives ptxas's registers, stack and spills
           of every kernel and, per N tile, the product kernel's
           registers, spills, dynamic shared memory and any note on
           setmaxnreg;
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
           pointwise_conv on CUDA tensors launches dX's walk (dx_*) and
           product (dx_product) and dW's product (dw_product) over the
           forward's kept means, no dW walk (dw_* 0); dW and
           dX with the external counts of the parity phase vs their plain
           versions, bits identical run to run;
  train    the train CLI's function in-process at full width, 22 steps
           each: s3dis_synthetic_local (CSR walk) and modelnet40_synthetic
           (dense walk), checkpoints in a temp dir; finite loss, grad norm
           > 0, changed weights, the dx_* and dw_product launches (no
           dw_* walk: dW reads the forward's kept means; counts
           zeroed just before each run, read just after); steps 3-20 run
           back to back with one sync at each end of the window (ms/step,
           trained points/s, as the JAX bench times steps), steps 21-22
           under torch.profiler (device ms per step, the union of the
           card's busy intervals, ``runtime.device_seconds``; idle share =
           1 - device ms / untraced ms); a second run of the same seed,
           stopped at step 11 and resumed, must end on the same bits; then infer
           serves one 200K request from the segmentation checkpoint;
  eval     python -m pointwise_torch.eval's flows on the train checkpoints:
           --votes 12 of modelnet40_synthetic, block voting and --streaming
           of s3dis_synthetic_local, each flow's JSON line, wall seconds
           and launches;
  partseg  ShapeNetPart through the train CLI's function at full width (6 x
           124 trunk, 8 x 2048 points, 16 categories, 48 synthetic parts,
           bf16 convs; every conv on the dense walk), 20 steps timed as the
           train phase (window 3-18, traced 19-20): finite loss, grad norm
           > 0, changed weights, 6 forwards per step and the dW / dX
           launches the hooks expect (counts zeroed just before, read just
           after), stop-at-10-and-resume bits; eval.main on its checkpoint;
           one test batch's logits on the card against the same model on
           the CPU (the plain versions, ``compare``'s bf16 tolerance);
  batchnorm s3dis_synthetic_local --norm batch, 22 steps (CSR walk), timed
           over the train phase's window (3-20, traced 21-22) so its ms/step
           compares with the LayerNorm run's: running averages moved and
           finite, resume bits; block voting of its checkpoint on the
           running averages;
  remat    remat=False and then remat=True through the train CLI's
           function at full width, 6 steps each (timed as the train phase:
           window 3-4, traced 5-6): s3dis_synthetic_local (CSR walk) with
           LayerNorm and with --norm batch, shapenetpart and
           modelnet40_synthetic (dense walk); losses, grad norms, every
           metric and the final state_dict (running averages included)
           bit-identical, the forward's walk and product launched once
           more per block and step (the recompute), dW's and dX's as
           often; each run's peak device memory above what was allocated
           before it, ms per step and device ms per kernel family;
  exact    streamed logits == a direct full-scene forward on a ~20K scene
           (f32 convs, 2e-4);
  spatial  the ring and gather strategies of spatial parallelism.  (a) One
           process: the largest served CSR call (layer 3, 1 x 172,032
           candidates / 73,728 centers, 124 wide, bf16) split into 4
           candidate slabs through the public ops: pointwise_conv_counts on
           the whole set, 4 ext_counts partials summed in f32 against the
           forward (``compare``), with the CUDA-event ms of the counts call,
           each partial and the forward on the whole set, and the counts
           equal to the forward's own bit for bit.  (b) 2 ranks
           spawned on cuda:0 over gloo (host-staged; NCCL refuses two ranks
           on one card), s3dis_synthetic_local at full width, 8 x 4096, bf16,
           dropout and jitter 0: 3 steps of the train CLI's function with
           --sp 2 (gather), 3 of Trainer(mesh, space_axis="space") with
           impl="spatial:space:ring", and 3 of a ring classifier at
           modelnet40_synthetic (32 x 1024: the counts and partials take
           the dense walk), 3 of the segmentation ring at 2 x 8192 (each
           rank's slab of 4,096 candidates takes the CSR walk, so do its
           partials and dW's and dX's walks in the backward), and 3 of
           --sp 2 --norm batch (gather, moments reduced over both ranks);
           each run's first loss against the
           single-device trainer's on the same batch (2e-3, the JAX
           package's bf16 SPMD pin), grad norm > 0, its launches (counts
           zeroed just before, read just after, summed over the ranks) and
           ms/step (steps 2-3 back to back), then one more step under
           torch.profiler on each rank: rank 0's device ms of that step,
           its counts kernel's ms and share; and the segmentation ring once
           more with remat=True: every step's metrics and the final state
           bit-identical to the ring without remat, its counts pre-pass and
           partials launched twice as often (recomputed in the backward).
           No rate of (b) is a multi-card number;
  serve_parallel  infer's --serve under a mesh: ranks spawned on cuda:0
           over gloo run ``launch.serve_worker`` (infer.main) with the
           serve phase's model and weights: --dp on 2 ranks (data 2), --sp
           2 on 2 (space 2), --dp --sp 2 on 4 (data 2 x space 2); each
           warms on 200K, then serves synth:200000, does_not_exist.npy
           (one error reply, the ranks keep serving), synth:1000000 and
           the small-object scan file; per run every reply, each rank's
           forward launches (counts zeroed just before, read just after;
           every rank must launch both walks and the product), each rank's
           resident-scene bytes of the 1M request (halved under space 2),
           and the 200K scene's logits through stream_apply_layered under
           the run's mesh against the single-device engine: bit for bit
           under space 2 alone, within 1e-4 x max |logit| under data 2;
           and rank 0's accuracy and mIoU of each served scene against the
           serve phase's single-device replies to the same requests:
           equal under space 2 alone, within 1e-4 (one unit of the
           replies' fourth decimal) under data 2.  Its rates are of ranks
           sharing one card over gloo, not multi-card rates;
  subblock pointwise_conv(..., subblock=8) at layer 0 of
           s3dis_synthetic_local (the first training batch, 8 x 4096
           morton-sorted block points, 6 -> 124, radius 0.1, bf16): the
           forward and loss.backward() with the sub-block branch (its cap
           set to the block, as the default cap of 3 x 512 overflows on
           these blocks) against the plain conv (``compare``'s bf16
           tolerance, ``compare_grad``), the branch the default cap takes,
           and radius 2.0 (larger than the block), which must take the
           plain conv; the CUDA-event ms of the forward and backward of
           each;
  tools    the profiler tools of pointwise_torch/tools in-process:
           attribute_train_step --config seg (6 untraced and 6 traced
           steps; op total <= device ms <= untraced ms), attribute_streaming
           at 200K points (device seconds > 0), sweep_seg_conv --quick and
           anchor_sweep at cls_synthetic_hard, 2 seeds x 20 steps (the
           path, not the accuracy);
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
           (``library_ms``; cuBLAS, never called by the port; both over
           20 calls: a product runs for about a tenth of a millisecond,
           and one stall of the host would move a mean of 5); the
           forward's and dX's also the TMA / wgmma kernel's tile (rows x N,
           stages, cluster, grid), the bytes of W its tiles read from L2
           (``product_plan``) and the row-shard check: the product of rows
           64.. equal bit for bit to the same rows of the whole product;
           dW's its plan (tile, stages, the centers' slices and chunk, the
           grid) and the bytes of its slices' partial sums
           (``dw_product_plan``).
           The counts
           kernel at the shapes of the spatial phase's rings (CSR: 8 x 2048
           centers of 8 x 4096 candidates; dense: 32 x 512 of 32 x 1024)
           equal to its plain version and to itself launched again, bit for
           bit, and the external-counts forward.  Then the
           same rows at ShapeNetPart's widest-radius layer (tagged
           ``path``), outside the kernels line.
After each phase a ``clock`` line gives its wall seconds.  Then the
``kernels`` line (thirteen kernels; dW's two walks run only in the ring,
so their launches are the ring's), the nvidia-smi line and, last, the
result line.
Any failure raises: the script exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.  The reader of the JAX
trainer's orbax checkpoints (``convert.read_jax_checkpoint``) does not run
here: it needs ``tensorstore``, and JAX to write a checkpoint, and the card
machine has neither; tests/test_torch_jax_checkpoint.py holds it to the
JAX trainer's checkpoints on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
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
    "dw_product": (f"{_PALLAS}:434", f"{_CSRC}/pointwise_conv_product.cuh"),
    "dx_dense": (f"{_PALLAS}:527", f"{_CSRC}/pointwise_conv_dx.cu"),
    "dx_csr": (f"{_PALLAS}:748", f"{_CSRC}/pointwise_conv_dx.cu"),
    "dx_product": (f"{_PALLAS}:476", f"{_CSRC}/pointwise_conv_product.cuh"),
    "counts_dense": (f"{_PALLAS}:1317", f"{_CSRC}/pointwise_conv_counts.cu"),
    "counts_csr": (f"{_PALLAS}:1317", f"{_CSRC}/pointwise_conv_counts.cu"),
    "fwd_ext_dense": (f"{_PALLAS}:1366", f"{_CSRC}/pointwise_conv_fwd.cu"),
    "fwd_ext_csr": (f"{_PALLAS}:1366", f"{_CSRC}/pointwise_conv_fwd.cu"),
}
# calls per CUDA-event timing of a product and of its library call
PRODUCT_REPS = 20
# f32 operations per candidate a counts walk tests: 3 subtractions, 3
# multiplications and 2 additions for the squared distance, 1 comparison
COUNTS_OPS_PER_PAIR = 9
SPATIAL_STEPS = 3
SPMD_LOSS_RTOL = 2e-3
# steps 3..steps-2 timed, the last two traced (timed_train); the BatchNorm
# run times the same window as the LayerNorm one it is compared with
TRAIN_STEPS = 22
PARTSEG_STEPS = 20
TRAIN_CONFIGS = (("s3dis_synthetic_local", "csr"),
                 ("modelnet40_synthetic", "dense"))
# each remat run and the run without remat it is held to: steps 3-4 timed,
# 5-6 traced (timed_train)
REMAT_STEPS = 6
# (configuration, --norm, the walk its forwards take) of the remat phase
REMAT_RUNS = (("s3dis_synthetic_local", "layer", "csr"),
              ("s3dis_synthetic_local", "batch", "csr"),
              ("shapenetpart", "layer", "dense"),
              ("modelnet40_synthetic", "layer", "dense"))


def emit(rec):
    print(json.dumps(rec), flush=True)


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
    from pointwise_torch.ops.pointwise_conv import DW_XBAR, conv_layout

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
    # the backward of the public op runs the kernels: dW's product over the
    # forward's kept means, dX's walk and product
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
    if any(launches[k] != 1 for k in ("dx_dense", "dx_csr")) \
            or launches["dw_dense"] or launches["dw_csr"] \
            or launches["dw_product"] != 2 or launches["dx_product"] != 2 \
            or DW_XBAR != {"kept": 2, "walked": 0}:
        raise AssertionError(f"backward did not launch the kernels: "
                             f"{launches}, {DW_XBAR}")
    emit({"phase": "grad", "ok": True, "cases": cases,
          "backward_launches": launches, "dw_xbar": dict(DW_XBAR)})


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
    call launches: dW's product (``dw_product_<walk>``; dW reads the
    forward's kept means, no walk) and dX's walk (``dx_<walk>``).  A
    conv's layer is told by its radius (``radii``); ``prefix`` is the
    family its calls are filed under ("fwd", "dw")."""

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
                self.backward_calls[(f"dw_product_{walk}", layer)] += int(
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


def timed_train(dev, argv, steps, remat=False):
    """``cli.main(argv + ["--steps", steps], remat=remat)`` timed as the JAX
    bench times a run (bench.py: steps back to back, one sync at the end):
    steps 3 .. steps-2 run with no host sync of the script's own, the card
    is synchronised only at the two ends of that window, and the last two
    steps run under torch.profiler after it (``runtime.StepWindow``).
    Returns (trainer, per-step metrics as floats, timing): ms per untraced
    step, the device ms per step of the traced steps (the union of the
    card's busy intervals), the device idle share 1 - device / untraced
    ms, and the traced steps' device ms per kernel family."""
    from pointwise_torch.train import cli
    from pointwise_torch.utils.runtime import StepWindow, sync

    window = StepWindow(dev, first=2, last=steps - 2, end=steps)
    metrics = []

    def on_step(step, m):
        metrics.append(m)               # device scalars: read after the run
        window(step)

    trainer = cli.main(argv + ["--steps", str(steps)], on_step=on_step,
                       remat=remat)
    sync(dev)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return trainer, metrics, dict(steps=steps, **window.summary())


def same_state(a, b):
    """True when two models' state_dicts hold the same bits."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    return sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k])
                                            for k in sa)


def state_digest(model):
    """sha256 of a model's state_dict (names and bytes, in name order)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def resumed_bits_equal(dev, argv, steps, trainer, workdir):
    """The same run stopped half way and resumed from its checkpoint must
    end on ``trainer``'s bits (every reduction runs in a fixed order)."""
    from pointwise_torch.train import cli

    common = argv + ["--device", dev.type, "--checkpoint-dir", workdir]
    cli.main(common + ["--steps", str(steps // 2)])
    resumed = cli.main(common + ["--steps", str(steps), "--resume"])
    return same_state(trainer.model, resumed.model)


def phase_train(dev, workdir, steps=TRAIN_STEPS):
    """Both configurations through the train CLI's function (timed_train);
    returns ({config: summary}, {(kernel_walk, layer): recorded conv call},
    {(kernel_walk, layer): dW product / dX walk launches per training
    step},
    {config: checkpoint directory})."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.train import cli, get_config

    summaries, calls, per_step, ckpts = {}, {}, {}, {}
    for config, walk in TRAIN_CONFIGS:
        cfg = get_config(config)
        ck = ckpts[config] = os.path.join(workdir, config)
        recorder = ConvRecorder(cfg.radii, prefix="dw")
        tk.reset_launches()
        trainer, metrics, timing = timed_train(
            dev, ["--config", config, "--device", dev.type,
                  "--checkpoint-dir", ck], steps)
        launches = dict(tk.LAUNCHES)
        recorder.remove()
        initial, _ = (cli.build_segmenter if walk == "csr"
                      else cli.build_classifier)(cfg, dev)
        changed = not same_state(trainer.model, initial)
        repeat = resumed_bits_equal(dev, ["--config", config], steps,
                                    trainer,
                                    os.path.join(workdir, f"{config}_2"))
        rec = dict(config=config, walk=walk, batch=cfg.batch_size,
                   points=cfg.num_points, launches=launches,
                   weights_changed=changed, resumed_run_bitwise_equal=repeat,
                   trained_points_per_s=cfg.batch_size * cfg.num_points
                   / timing["ms_per_step"] * 1e3,
                   loss_first=metrics[0]["loss"], loss_last=metrics[-1]["loss"],
                   grad_norm_min=min(m["grad_norm"] for m in metrics),
                   **timing)
        emit({"phase": "train", **rec})
        finite = all(math.isfinite(m["loss"]) for m in metrics)
        dw, dx = f"dw_product_{walk}", f"dx_{walk}"
        per_layer = {k: sum(v for (n, _), v in
                            recorder.backward_calls.items() if n == k)
                     for k in (dw, dx)}
        if not (finite and rec["grad_norm_min"] > 0 and changed and repeat
                and len(metrics) == steps
                and launches[dx] > 0 and per_layer[dx] == launches[dx]
                and launches["dx_product"] == launches[dx]
                # dW: the product over the forward's means, no walk
                and per_layer[dw] == launches["dw_product"] > 0
                and launches[f"dw_{walk}"] == 0):
            raise AssertionError(f"training failed: {rec}, hooks saw "
                                 f"{per_layer}")
        summaries[config] = rec
        calls.update(recorder.calls)
        per_step.update({k: v / steps
                         for k, v in recorder.backward_calls.items()})
    return summaries, calls, per_step, ckpts


def phase_partseg(dev, workdir, steps=PARTSEG_STEPS):
    """ShapeNetPart through the train CLI's function at full width (6 x 124,
    8 x 2048 points, every conv on the dense walk), timed as the train
    phase; the forward's, dW's and dX's launches of that run (counts zeroed
    just before, read just after), the resume check, ``eval.main`` on its
    checkpoint, and one test batch's logits on the card against the same
    model on the CPU (the plain versions).  Returns the recorded conv calls
    and the dW / dX launches per step of each (kernel, layer)."""
    import copy

    import torch

    from pointwise_torch import convert
    from pointwise_torch import eval as evaluate
    from pointwise_torch.data import shapenetpart
    from pointwise_torch.infer import load_trained
    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.train import cli, get_config

    config = "shapenetpart"
    cfg = get_config(config)
    ck = os.path.join(workdir, config)
    recorder = ConvRecorder(cfg.radii, prefix="dw")
    tk.reset_launches()
    trainer, metrics, timing = timed_train(
        dev, ["--config", config, "--device", dev.type, "--checkpoint-dir",
              ck], steps)
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    recorder.remove()
    data = shapenetpart.load_shapenetpart(None, "train", cfg.num_points,
                                          seed=cfg.seed)
    initial, _ = cli.build_partseg(cfg, data, dev)
    changed = not same_state(trainer.model, initial)
    repeat = resumed_bits_equal(dev, ["--config", config], steps, trainer,
                                os.path.join(workdir, f"{config}_2"))
    per_layer = {k: sum(v for (n, _), v in recorder.backward_calls.items()
                        if n == k) for k in ("dw_product_dense", "dx_dense")}
    rec = dict(config=config, walk="dense", batch=cfg.batch_size,
               points=cfg.num_points, parts=data.num_parts,
               blocks=len(cfg.channels), launches=launches,
               weights_changed=changed, resumed_run_bitwise_equal=repeat,
               trained_points_per_s=cfg.batch_size * cfg.num_points
               / timing["ms_per_step"] * 1e3,
               loss_first=metrics[0]["loss"], loss_last=metrics[-1]["loss"],
               grad_norm_min=min(m["grad_norm"] for m in metrics), **timing)
    emit({"phase": "partseg", **rec})
    fwd = len(cfg.channels) * steps
    if not (all(math.isfinite(m["loss"]) for m in metrics)
            and rec["grad_norm_min"] > 0 and changed and repeat
            and len(metrics) == steps
            and launches.get("fwd_dense") == fwd
            and launches.get("fwd_product") == fwd
            and "fwd_csr" not in launches
            and "dw_dense" not in launches    # dW reads the forward's means
            and launches.get("dx_dense") == per_layer["dx_dense"] > 0
            and launches.get("dw_product") == per_layer["dw_product_dense"]
            > 0
            and launches.get("dx_product") == per_layer["dx_dense"]):
        raise AssertionError(f"part segmentation training failed: {rec}, "
                             f"hooks saw {per_layer}")
    t0 = time.perf_counter()
    miou = evaluate.main(["--config", config, "--checkpoint-dir", ck,
                          "--device", dev.type])
    eval_s = time.perf_counter() - t0
    # one test batch: the card's kernels against the plain versions on the
    # CPU, the same weights
    model = cli.build_partseg(cfg, data, "cpu")[0]
    load_trained(model, ck, convert.load_shapenetpart)
    cpu_model = copy.deepcopy(model).eval()
    card_model = model.to(dev).eval()
    test = shapenetpart.load_shapenetpart(None, "test", cfg.num_points,
                                          synthetic_size=64, seed=cfg.seed)
    batch = next(shapenetpart.batches(test, cfg.batch_size, shuffle=False))
    with torch.inference_mode():
        y = card_model(*(torch.from_numpy(batch[k]).to(dev)
                         for k in ("points", "category"))).cpu()
        y_ref = cpu_model(*(torch.from_numpy(batch[k])
                            for k in ("points", "category")))
    err, ok = compare(y, y_ref, "bfloat16")
    emit({"phase": "partseg", "eval_wall_s": eval_s, "instance_miou": miou,
          "logits_vs_cpu_plain": dict(shape=list(y.shape), max_abs_err=err,
                                      max_abs=float(y_ref.abs().max()),
                                      ok=ok)})
    if not (ok and 0.0 <= miou <= 1.0):
        raise AssertionError(f"part segmentation eval failed: {err}, {miou}")
    return recorder.calls, {k: v / steps
                            for k, v in recorder.backward_calls.items()}


def phase_batchnorm(dev, workdir, steps=TRAIN_STEPS):
    """s3dis_synthetic_local with --norm batch (every conv on the CSR walk),
    timed as the train phase: the running averages moved and stay finite,
    the resume check, then block voting of its checkpoint (running
    averages)."""
    import torch

    from pointwise_torch import eval as evaluate
    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    config, walk = TRAIN_CONFIGS[0]
    argv = ["--config", config, "--norm", "batch"]
    ck = os.path.join(workdir, "batchnorm")
    tk.reset_launches()
    trainer, metrics, timing = timed_train(
        dev, argv + ["--device", dev.type, "--checkpoint-dir", ck], steps)
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    stats = {k: v for k, v in trainer.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    moved = bool(stats) and all(
        bool(torch.isfinite(v).all()) and not torch.equal(
            v, torch.zeros_like(v) if k.endswith("mean")
            else torch.ones_like(v)) for k, v in stats.items())
    repeat = resumed_bits_equal(dev, argv, steps, trainer,
                                os.path.join(workdir, "batchnorm_2"))
    rec = dict(config=config, norm="batch", walk=walk, launches=launches,
               running_stats_moved_and_finite=moved,
               resumed_run_bitwise_equal=repeat,
               loss_first=metrics[0]["loss"], loss_last=metrics[-1]["loss"],
               grad_norm_min=min(m["grad_norm"] for m in metrics), **timing)
    emit({"phase": "batchnorm", **rec})
    if not (moved and repeat and rec["grad_norm_min"] > 0
            and all(math.isfinite(m["loss"]) for m in metrics)
            and all(launches.get(f"{k}_{walk}", 0) > 0 for k in ("fwd", "dx"))
            and launches.get("dw_product", 0) > 0
            and f"dw_{walk}" not in launches):
        raise AssertionError(f"BatchNorm training failed: {rec}")
    t0 = time.perf_counter()
    m = evaluate.main(argv + ["--checkpoint-dir", ck, "--device", dev.type])
    emit({"phase": "batchnorm", "eval": "block voting",
          "eval_wall_s": time.perf_counter() - t0,
          "accuracy": m["accuracy"], "miou": m["miou"]})
    if not 0.0 <= m["accuracy"] <= 1.0:
        raise AssertionError(f"BatchNorm block voting failed: {m}")


def phase_remat(dev, runs=REMAT_RUNS, steps=REMAT_STEPS):
    """Each of ``runs`` through the train CLI's function at full width,
    ``steps`` steps with remat=False and then with remat=True (timed_train):
    the losses, grad norms, every other metric and the final state_dict
    (parameters and BatchNorm running averages) must hold the same bits;
    with remat every block's forward kernels launch a second time inside
    the backward, dW's and dX's as often as without.  Per run: the peak
    device memory above what was allocated before it
    (``max_memory_allocated`` after ``reset_peak_memory_stats``), ms per
    untraced step, device ms per step and per kernel family."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.train import get_config

    summaries = []
    for config, norm, walk in runs:
        argv = ["--config", config, "--norm", norm, "--device", dev.type]
        got = {}
        for remat in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tk.reset_launches()
            trainer, metrics, timing = timed_train(dev, argv, steps, remat)
            got[remat] = dict(
                trainer=trainer, metrics=metrics,
                launches={k: v for k, v in tk.LAUNCHES.items() if v},
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                **{k: timing.get(k) for k in (
                    "ms_per_step", "device_ms_per_step", "device_idle_share",
                    "kernel_ms_per_step")})
        plain, remat = got[False], got[True]
        blocks = len(get_config(config).channels)
        fwd = f"fwd_{walk}"
        rec = dict(config=config, norm=norm, walk=walk, steps=steps,
                   **{f"{k}{tag}": r[k] for tag, r in (("", plain),
                                                       ("_remat", remat))
                      for k in ("launches", "peak_bytes", "ms_per_step",
                                "device_ms_per_step", "device_idle_share",
                                "kernel_ms_per_step")},
                   losses=[m["loss"] for m in plain["metrics"]],
                   metrics_equal=plain["metrics"] == remat["metrics"],
                   state_equal=same_state(plain["trainer"].model,
                                          remat["trainer"].model))
        emit({"phase": "remat", **rec})
        pl, rl = plain["launches"], remat["launches"]
        if not (rec["metrics_equal"] and rec["state_equal"]
                and len(plain["metrics"]) == steps
                and all(math.isfinite(m["loss"]) for m in plain["metrics"])
                and rl.get(fwd, 0) - pl.get(fwd, 0) == blocks * steps
                and rl.get("fwd_product", 0) - pl.get("fwd_product", 0)
                == blocks * steps
                and all(rl.get(k) == pl.get(k) > 0 for k in (
                    f"dx_{walk}", "dw_product", "dx_product"))
                and f"dw_{walk}" not in rl and f"dw_{walk}" not in pl):
            raise AssertionError(f"remat != no remat: {rec}")
        summaries.append(rec)
    return summaries


def phase_tools(dev):
    """The profiler tools on the card, in this process (their records
    re-emitted here): attribute_train_step at the segmentation step (op
    total <= device ms <= untraced ms), attribute_streaming at 200K points
    (device seconds > 0), sweep_seg_conv --quick and anchor_sweep at 2
    seeds x 20 steps of cls_synthetic_hard (the path, not the accuracy)."""
    import contextlib
    import io

    from pointwise_torch.tools import (anchor_sweep, attribute_streaming,
                                       attribute_train_step, sweep_seg_conv)

    def quiet(main, argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return main(argv + ["--device", dev.type])

    step = quiet(attribute_train_step.main, ["--config", "seg", "--steps",
                                             "6"])
    emit({"phase": "tools", "tool": "attribute_train_step", **step})
    if not (isinstance(step["device_ms_per_step"], float)
            and step["op_ms_per_step"] <= step["device_ms_per_step"]
            <= step["ms_per_step"]):
        raise AssertionError(f"attribute_train_step: {step}")
    passes = quiet(attribute_streaming.main, ["--points", "200000"])
    for rec in passes:
        emit({"phase": "tools", "tool": "attribute_streaming", **rec})
    if not (isinstance(passes[-1].get("device_s"), float)
            and passes[-1]["device_s"] > 0):
        raise AssertionError(f"attribute_streaming: {passes[-1]}")
    rows = quiet(sweep_seg_conv.main, ["--quick"])
    for rec in rows:
        emit({"phase": "tools", "tool": "sweep_seg_conv", **rec})
    if not (len(rows) == 4 and all(isinstance(r["sum_ms"], float)
                                   and r["sum_ms"] > 0 for r in rows)):
        raise AssertionError(f"sweep_seg_conv: {rows}")
    t0 = time.perf_counter()
    anchor = quiet(anchor_sweep.main, ["--config", "cls_synthetic_hard",
                                       "--seeds", "0", "1", "--steps", "20"])
    emit({"phase": "tools", "tool": "anchor_sweep",
          "wall_s": time.perf_counter() - t0, **anchor})
    if not all(0.0 <= v <= 1.0 for v in anchor["value_per_seed"]):
        raise AssertionError(f"anchor_sweep: {anchor}")


def phase_eval(dev, ckpts):
    """``python -m pointwise_torch.eval``'s flows on the train phase's
    checkpoints: rotation voting (12 votes) of the classifier, block voting
    and exact streaming of the segmenter; each flow's wall seconds and
    launches (counts zeroed just before, read just after)."""
    import torch

    from pointwise_torch import eval as evaluate
    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    seg, cls = (c for c, _ in TRAIN_CONFIGS)
    for flow, argv in (
            ("rotation voting", ["--config", cls, "--votes", "12",
                                 "--checkpoint-dir", ckpts[cls]]),
            ("block voting", ["--config", seg, "--checkpoint-dir",
                              ckpts[seg]]),
            ("streaming", ["--config", seg, "--streaming",
                           "--checkpoint-dir", ckpts[seg]])):
        tk.reset_launches()
        t0 = time.perf_counter()
        out = evaluate.main(argv + ["--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        value = out if isinstance(out, float) else out["accuracy"]
        emit({"phase": "eval", "flow": flow, "config": argv[1],
              "wall_s": wall, "accuracy": value,
              "launches": {k: v for k, v in tk.LAUNCHES.items() if v}})
        if not (0.0 <= value <= 1.0 and any(tk.LAUNCHES.values())):
            raise AssertionError(f"eval {flow} failed: {out}")


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
    that a sharded step computes the unsharded one's function, and the
    segmenter again at 2 x 8192 points, whose 4,096-candidate slabs on 2
    ranks take the CSR walk (``csr_walk``)."""
    from pointwise_torch.train import get_config

    seg = dataclasses.replace(get_config("s3dis_synthetic_local"),
                              dropout=0.0)
    return (seg, dataclasses.replace(get_config("modelnet40_synthetic"),
                                     dropout=0.0),
            dataclasses.replace(seg, num_points=8192, batch_size=2))


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


def spatial_worker(mesh, steps, configs):
    """One rank of the spatial phase's 2-rank runs (spawned by
    pointwise_torch.parallel.launch, which imports this module): the
    gather strategy through the train CLI's function (--sp 2, then --sp 2
    --norm batch), then the ring for the segmenter and for the classifier
    through the Trainer.  Each run takes ``steps`` steps timed as
    ``StepWindow`` times them and one more under the profiler.  Returns,
    per run, the launches, the step metrics, ms/step and the traced
    step's device ms per kernel family."""
    import contextlib
    import io

    from pointwise_torch.data import augment, pipeline
    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.models import PointwiseClassifier, PointwiseSegmenter
    from pointwise_torch.parallel.spmd import cls_spmd_loss_fn, seg_spmd_loss_fn
    from pointwise_torch.train import cli
    from pointwise_torch.train.trainer import Trainer, step_seed
    from pointwise_torch.utils.runtime import StepWindow, sync

    dev = mesh.device
    seg, cls, seg_csr = configs
    if dev.type == "cuda":
        tk.build_libraries()
    out = {}

    def run(name, go):
        metrics = []
        window = StepWindow(dev, 1, steps, steps + 1)

        def on_step(step, m):
            window(step)
            metrics.append({k: float(v) for k, v in m.items()})

        sync(dev)
        tk.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):   # rank 0's JSONL
            trainer = go(on_step)
        sync(dev)
        summary = window.summary(top=4)
        out[name] = dict(launches=dict(tk.LAUNCHES), metrics=metrics,
                         ms_per_step=summary.pop("ms_per_step"),
                         trace=summary,
                         state_sha256=state_digest(trainer.model))

    def trained(cfg, model, loss_fn, on_step, **spmd):
        trainer = Trainer(model.to(dev), loss_fn, cfg.optimizer, mesh=mesh,
                          space_axis="space", **spmd)
        for step, batch in enumerate(spatial_batches(cfg, steps + 1)):
            on_step(step + 1, trainer.step(pipeline.to_device(batch, dev),
                                           step_seed(cfg.seed, step)))
        return trainer

    def seg_ring(remat, seg=seg):
        return PointwiseSegmenter(
            num_classes=seg.num_classes, in_features=seg.in_features,
            channels=seg.channels, radii=seg.radii, head_dims=seg.head_dims,
            dropout_rate=0.0, impl="spatial:space:ring", remat=remat,
            use_global_context=seg.global_context, mesh=mesh,
            generator=cli._init_generator(seg))

    args = cli.parse_args(["--config", seg.name, "--steps", str(steps + 1),
                           "--sp", "2", "--device", dev.type])
    run("gather", lambda on_step: cli.train_segmentation(
        seg, args, dev, on_step, mesh, jitter=0.0))
    run("gather_bn", lambda on_step: cli.train_segmentation(
        dataclasses.replace(seg, norm="batch"), args, dev, on_step, mesh,
        jitter=0.0))
    run("seg_ring", lambda on_step: trained(seg, seg_ring(False),
                                            seg_spmd_loss_fn(), on_step))
    run("seg_ring_remat", lambda on_step: trained(seg, seg_ring(True),
                                                  seg_spmd_loss_fn(),
                                                  on_step))
    run("seg_ring_csr", lambda on_step: trained(
        seg_csr, seg_ring(False, seg_csr), seg_spmd_loss_fn(), on_step))
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
        counts_equal = bool(torch.equal(tk.conv_counts(*walk),
                                        tk.conv_fwd(**kw_all)[1]))
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
               max_abs_y=float(full.abs().max()), ok=ok,
               counts_equal_forward=counts_equal, counts_ms=counts_ms,
               partial_ms=part_ms, partials_total_ms=sum(part_ms),
               forward_ms=fwd_ms)
    emit({"phase": "spatial", "served_split": rec})
    if not (ok and counts_equal and launches["counts_csr"] == 1
            and launches["fwd_ext_csr"] == slabs):
        raise AssertionError(f"served-scale ring split failed: {rec}")
    return launches, (mod, parts[0], cnt_in, center_mask)


def ring_trace(trace):
    """Rank 0's traced step of a spatial run: device ms, the counts
    kernel's ms and its share of the device ms ("not measured" without
    device time)."""
    from pointwise_torch.utils.runtime import NOT_MEASURED

    dev_ms = trace["device_ms_per_step"]
    if dev_ms == NOT_MEASURED:
        return dict(device_ms=dev_ms, counts_ms=dev_ms, counts_share=dev_ms)
    counts = trace["kernel_ms_per_step"]["counts"]
    return dict(device_ms=dev_ms, counts_ms=counts,
                counts_share=counts / dev_ms,
                traced_wall_ms=trace["traced_ms_per_step"],
                kernel_ms={k: v for k, v in
                           trace["kernel_ms_per_step"].items() if v})


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
    from pointwise_torch.utils.runtime import sync

    seg, cls, seg_csr = configs or spatial_configs()
    single, calls = {}, {}
    seg_step = functools.partial(cli.train_segmentation, jitter=0.0)
    for key, cfg, train in (("seg", seg, seg_step),
                            ("seg_bn", dataclasses.replace(seg, norm="batch"),
                             seg_step),
                            ("seg_csr", seg_csr, seg_step),
                            ("cls", cls, cli.train_classification)):
        first = []
        recorder = ConvRecorder(cfg.radii, prefix="ring")
        args = cli.parse_args(["--config", cfg.name, "--steps", "1",
                               "--device", dev.type])
        with contextlib.redirect_stdout(io.StringIO()):   # its JSONL
            train(cfg, args, dev,
                  lambda step, m: first.append(float(m["loss"])))
        recorder.remove()
        single[key] = first[0]
        if key in ("seg", "cls"):
            calls[cfg.name] = recorder.calls
    sync(dev)
    t0 = time.perf_counter()
    res = launch.spawn(spatial_worker, 2, os.path.join(workdir, "ranks"),
                       data=1, space=2, backend="gloo",
                       device="cuda:0" if dev.type == "cuda" else "cpu",
                       kwargs=dict(steps=steps, configs=(seg, cls, seg_csr)),
                       timeout=900, comm_timeout=300, threads=4)
    wall = time.perf_counter() - t0
    launches = collections.Counter()
    runs_by_name = {}
    # the gather's conv is the Function: dW reads the forward's means
    gather = ("fwd_csr", "dx_csr", "dw_product", "dx_product")
    for name, key, cfg, need in (
            ("gather", "seg", seg, gather),
            ("gather_bn", "seg_bn", dataclasses.replace(seg, norm="batch"),
             gather),
            ("seg_ring", "seg", seg, ("counts_csr", "fwd_ext_dense",
                                      "dw_dense", "dx_dense", "dw_product",
                                      "dx_product")),
            ("seg_ring_remat", "seg", seg, ("counts_csr", "fwd_ext_dense",
                                            "dw_dense", "dx_dense",
                                            "dw_product", "dx_product")),
            ("seg_ring_csr", "seg_csr", seg_csr, (
                "counts_csr", "fwd_ext_csr", "dw_csr", "dx_csr",
                "dw_product", "dx_product")),
            ("cls_ring", "cls", cls, ("counts_dense", "fwd_ext_dense",
                                      "dw_dense", "dx_dense", "dw_product",
                                      "dx_product"))):
        runs = [r[name] for r in res]
        got = collections.Counter()
        for r in runs:
            got.update(r["launches"])
        first = runs[0]["metrics"][0]["loss"]
        rel = abs(first - single[key]) / abs(single[key])
        rec = dict(run=name, config=cfg.name, norm=cfg.norm, ranks=2,
                   steps=steps, launches={k: v for k, v in got.items() if v},
                   loss_first=first, loss_first_single_device=single[key],
                   loss_rel_diff=rel, tol=SPMD_LOSS_RTOL,
                   loss_last=runs[0]["metrics"][-1]["loss"],
                   grad_norm_min=min(m["grad_norm"] for r in runs
                                     for m in r["metrics"]),
                   ms_per_step=[r["ms_per_step"] for r in runs],
                   traced_step=ring_trace(runs[0]["trace"]),
                   communication="gloo, host-staged, 2 ranks sharing one card "
                                 "(not a multi-card rate)")
        emit({"phase": "spatial", **rec})
        same = all(r["metrics"] == runs[0]["metrics"] for r in runs)
        if not (rel <= SPMD_LOSS_RTOL and rec["grad_norm_min"] > 0 and same
                and all(got[k] > 0 for k in need)
                and not (name.startswith("gather") and got["dw_csr"])
                and all(math.isfinite(m["loss"]) for m in runs[0]["metrics"])):
            raise AssertionError(f"spatial run {name} failed: {rec}")
        launches.update(got)
        runs_by_name[name] = (runs, got)
    # remat: the same bits, the ring's forward (counts pre-pass and
    # partials) launched again inside the backward
    (plain, plain_l), (remat, remat_l) = (runs_by_name[k] for k in (
        "seg_ring", "seg_ring_remat"))
    rec = dict(run="seg_ring_remat", against="seg_ring",
               metrics_equal=all(a["metrics"] == b["metrics"]
                                 for a, b in zip(plain, remat)),
               state_equal=all(a["state_sha256"] == b["state_sha256"]
                               for a, b in zip(plain, remat)),
               forward_launches={k: (plain_l[k], remat_l[k])
                                 for k in ("counts_csr", "fwd_ext_dense")},
               backward_launches={k: (plain_l[k], remat_l[k])
                                  for k in ("dw_dense", "dx_dense")})
    emit({"phase": "spatial", **rec})
    if not (rec["metrics_equal"] and rec["state_equal"]
            and all(b == 2 * a for a, b in rec["forward_launches"].values())
            and all(a == b for a, b in rec["backward_launches"].values())):
        raise AssertionError(f"the ring with remat differs: {rec}")
    emit({"phase": "spatial", "ranks_wall_s": wall})
    return launches, calls


# (name, infer flags, data, space) of the serve_parallel runs
SERVE_MESHES = (("dp", ["--dp"], 2, 1), ("sp", ["--sp", "2"], 1, 2),
                ("dp_sp", ["--dp", "--sp", "2"], 2, 2))
# data-2 logits against one device: the head's Linear layers are cuBLAS
# calls whose algorithm may change with the rows per rank
DATA_LOGITS_RTOL = 1e-4
# data-2 accuracy / mIoU against one device: a logit within that tolerance
# may flip one point's argmax, which moves a metric rounded to 4 decimals
# by at most one unit
DATA_METRIC_ATOL = 1e-4


def serve_parallel_worker(mesh, argv, requests, config, scene):
    """One rank of a serve_parallel run (spawned by
    pointwise_torch.parallel.launch, which imports this module): the
    serve CLI under the mesh, then the served model's logits of ``scene``
    through the engine under the same mesh."""
    import torch

    from pointwise_torch.parallel import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = launch.serve_worker(mesh, argv=argv, requests=requests)
    out["logits"] = launch.stream_worker(
        mesh, config=config, scenes=[scene],
        precision="bfloat16", tile_size=4.0)["outs"][0]
    return out


def phase_serve_parallel(dev, workdir, smi, single_replies,
                         config="s3dis_synthetic",
                         sizes=(200_000, 1_000_000), warm_points=200_000):
    """infer --serve --dp / --sp on ranks sharing cuda:0 over gloo, against
    the single-device engine (the logits of a ``sizes[0]``-point scene) and
    the single-device server (``single_replies``: its replies to
    synth:<sizes[0]>, synth:<sizes[1]> and the scan file, in that order).
    Returns {run: summary}."""
    import numpy as np

    from pointwise_torch import infer
    from pointwise_torch.parallel import launch
    from pointwise_torch.streaming import stream_apply_layered
    from pointwise_torch.train import get_config

    cfg = get_config(config)
    model = infer.build_model(cfg, dev)
    xyz, rgb, _ = infer.big_scene(sizes[0], seed=3)
    feats = infer.scene_features(cfg, xyz, rgb)
    single = stream_apply_layered(infer.layered_apply(model), xyz, feats,
                                  radii=cfg.radii, tile_size=4.0,
                                  out_dim=cfg.num_classes, device=dev)
    scale = float(np.abs(single).max())
    scan = small_scan_file(os.path.join(workdir, "scan.npy"))
    requests = [f"synth:{sizes[0]}", "does_not_exist.npy", f"synth:{sizes[1]}",
                scan, "quit"]
    out = {}
    for name, flags, data, space in SERVE_MESHES:
        argv = ["--serve", "--config", config, "--device",
                dev.type, "--warm-points", str(warm_points), *flags]
        t0 = time.perf_counter()
        ranks = launch.spawn(serve_parallel_worker, data * space,
                             os.path.join(workdir, name), data=data,
                             space=space, backend="gloo",
                             device="cuda:0" if dev.type == "cuda" else "cpu",
                             kwargs=dict(argv=argv, requests=requests,
                                         config=config, scene=(xyz, feats)),
                             timeout=300, comm_timeout=240, threads=2)
        wall = time.perf_counter() - t0
        replies = ranks[0]["replies"]
        for rec in replies:
            emit({"phase": "serve_parallel", "run": name, "reply": rec})
        errors = [r for r in replies if "error" in r]
        served = [r for r in replies[1:] if "error" not in r]
        big = max(served, key=lambda r: r["n_points"])
        resident = [max(r["scenes"], key=lambda s: s["points"])
                    for r in ranks]
        diff = [float(np.abs(r["logits"] - single).max()) for r in ranks]
        tol = 0.0 if data == 1 else DATA_LOGITS_RTOL * scale
        metric_tol = 0.0 if data == 1 else DATA_METRIC_ATOL
        metric_diff = [abs(got[k] - want[k])
                       for got, want in zip(served, single_replies)
                       for k in ("accuracy", "miou")]
        fwd = ("fwd_csr", "fwd_dense", "fwd_product")
        rec = dict(
            run=name, data=data, space=space, ranks=data * space,
            wall_s=wall, pts_per_s={r["scene"]: r["pts_per_s"]
                                    for r in served},
            launches=[{k: r["launches"][k] for k in fwd} for r in ranks],
            coords=[list(r["coords"]) for r in ranks],
            resident_bytes_1m=[s["resident_bytes"] for s in resident],
            resident_points_1m=resident[0]["points"],
            logits_points=len(xyz), logits_max_abs_diff=diff,
            logits_tol=tol, max_abs_logit=scale,
            metrics_vs_single_device=[
                {k: (got[k], want[k]) for k in ("accuracy", "miou")}
                for got, want in zip(served, single_replies)],
            metric_max_abs_diff=max(metric_diff), metric_tol=metric_tol,
            bit_identical=[bool(np.array_equal(r["logits"], single))
                           for r in ranks],
            communication="one shared card, gloo (host-staged); not a "
                          "multi-card rate", nvidia_smi=smi)
        emit({"phase": "serve_parallel", **rec})
        want_bytes = -(-resident[0]["points"] // space) * 4 * (
            3 + cfg.in_features)
        if not (replies and replies[0].get("ready") and len(errors) == 1
                and errors[0]["scene"] == "does_not_exist.npy"
                and len(served) == 3 and "output" in served[-1]
                and len(single_replies) == 3
                and [r["n_points"] for r in served]
                == [r["n_points"] for r in single_replies]
                and max(metric_diff) <= metric_tol
                and big["n_points"] == resident[0]["points"]
                and all(ranks[i]["replies"] == [] for i in range(1,
                                                                len(ranks)))
                and all(v > 0 for r in rec["launches"] for v in r.values())
                and all(b == want_bytes for b in rec["resident_bytes_1m"])
                and all(d <= tol for d in diff)
                and (data > 1 or all(rec["bit_identical"]))):
            raise AssertionError(f"parallel serving failed: {rec}")
        out[name] = rec
    return out


def phase_subblock(dev, subblock=8, reps=5):
    """The op's sub-block mode at layer 0 of s3dis_synthetic_local on its
    first training batch: the forward and loss.backward() of each branch
    against the plain conv, and their CUDA-event ms."""
    import importlib

    import numpy as np
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk
    from pointwise_torch.train import get_config

    op = importlib.import_module("pointwise_torch.ops.pointwise_conv")
    cfg = get_config("s3dis_synthetic_local")
    batch = spatial_batches(cfg, 1)[0]
    points, feats, mask = (torch.from_numpy(batch[k]).to(dev)
                           for k in ("points", "features", "mask"))
    n = points.shape[1]
    rng = np.random.RandomState(9)
    cin, cout = feats.shape[2], cfg.channels[0]
    w = torch.from_numpy((rng.standard_normal((27, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(
        np.float32)).to(dev)
    branches = []
    plain_conv = op.pointwise_conv

    def spy(*args, **kw):
        if kw.get("centers") is not None:
            branches.append("subblock")
        return plain_conv(*args, **kw)

    def step(radius, **kw):
        f, wt = (t.clone().requires_grad_(True) for t in (feats, w))
        y = plain_conv(points, f, wt, bias, radius=radius, mask=mask,
                       precision="bfloat16", **kw)
        (y.float() ** 2).sum().backward()
        return y, f.grad, wt.grad

    def run(radius, **kw):
        """(outputs, branch taken, launches, forward+backward ms)"""
        del branches[:]
        op.pointwise_conv = spy
        try:
            tk.reset_launches()
            outs = step(radius, **kw)
            torch.cuda.synchronize()
            launches = {k: v for k, v in tk.LAUNCHES.items() if v}
            taken = branches[0] if branches else "plain"
        finally:
            op.pointwise_conv = plain_conv
        ms = cuda_time_ms(lambda: step(radius, **kw), reps=reps)
        return outs, taken, launches, ms

    radius = cfg.radii[0]
    dense, _, dense_launches, dense_ms = run(radius)
    sub, taken, sub_launches, sub_ms = run(radius, subblock=subblock,
                                           subblock_cap=n)
    checks = {}
    for key, a, b, cmp in (("y", sub[0], dense[0], compare),
                           ("d_features", sub[1], dense[1], compare_grad),
                           ("d_weights", sub[2], dense[2], compare_grad)):
        checks[f"{key}_max_abs_err"], checks[f"{key}_ok"] = cmp(
            a.detach().float(), b.detach().float(), "bfloat16")
    _, default_taken, _, default_ms = run(radius, subblock=subblock)
    wide = cfg.block_size * 2
    over, over_taken, _, over_ms = run(wide, subblock=subblock)
    plain_wide, _, _, plain_wide_ms = run(wide)
    rec = dict(config=cfg.name, layer=0, shape=list(points.shape),
               cin=cin, cout=cout, radius=radius, precision="bfloat16",
               subblock=subblock, subblock_cap=n, branch=taken,
               launches=sub_launches, plain_launches=dense_launches,
               ms=sub_ms, plain_ms=dense_ms, default_cap=3 * n // subblock,
               default_cap_branch=default_taken, default_cap_ms=default_ms,
               **checks,
               overflow=dict(radius=wide, branch=over_taken, ms=over_ms,
                             plain_ms=plain_wide_ms,
                             equal=all(torch.equal(a, b)
                                       for a, b in zip(over, plain_wide))))
    emit({"phase": "subblock", **rec})
    if not (taken == "subblock" and over_taken == "plain"
            and rec["overflow"]["equal"]
            and all(v for k, v in checks.items() if k.endswith("_ok"))):
        raise AssertionError(f"subblock failed: {rec}")
    return rec


def cuda_time_ms(fn, reps, warmup=1):
    from pointwise_torch.utils.runtime import event_ms

    return event_ms(fn, reps, warmup)


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


def product_build_report(tk):
    """ptxas's report of each bf16 product kernel (tag, N tile, registers,
    stack, spills, static shared memory, notes on setmaxnreg) with the
    dynamic shared memory its tile takes (``product_plan``): the forward's,
    dX's and dW's (tags FwdProduct, DxProduct, DwProduct)."""
    import re

    out = []
    for k in tk.ptxas_kernels(tk.LIBRARY["ptxas"], "pw_product_kernel"):
        bn = int(re.search(r"ELi(\d+)EE", k["kernel"])[1])
        tag = re.search(r"(Fwd|Dx|Dw)Product", k["kernel"])[0]
        out.append(dict(tag=tag, bn=bn, dynamic_smem=tk.product_plan(
            64, bn, 64, 1)["smem"], **{key: v for key, v in k.items()
                                        if key != "kernel"}))
    if len(out) != 3 * len(tk.PRODUCT_BN):
        raise AssertionError(f"ptxas reported {len(out)} product kernels, "
                             f"not {3 * len(tk.PRODUCT_BN)}")
    return out


def dw_design(xbar, g):
    """dW's product plan at these operands (``dw_product_plan``: tile,
    stages, the centers' slices, the persistent grid, the partial sums'
    bytes)."""
    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    plan = tk.dw_product_plan(*xbar.shape, g.shape[1],
                              tk.sm_count(xbar.device))
    return dict(tile={k: plan[k] for k in ("bm", "bn", "stages", "slices",
                                           "chunk", "grid")},
                part_bytes=plan["part_bytes"])


def product_design(fn, args):
    """The bf16 product's tile at these operands (rows x N, stages,
    cluster, the persistent grid) and the bytes of W its tiles read from
    L2 (``product_plan``), and the row-shard check: ``fn`` on rows 64.. of
    the A operand equals rows 64.. of ``fn`` on all of it, bit for bit
    (the serving mesh's row shards rest on it)."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    a = args[0]
    whole, shard = fn(*args), fn(a[64:], *args[1:])
    torch.cuda.synchronize()
    plan = tk.product_plan(a.shape[0], whole.shape[1], a.shape[1],
                           torch.cuda.get_device_properties(
                               a.device).multi_processor_count)
    same = bool(torch.equal(whole[64:], shard))
    if not same:
        raise AssertionError(f"a row shard's product differs: {fn.__name__} "
                             f"of {tuple(a.shape)}")
    return dict(tile={k: plan[k] for k in ("bm", "bn", "stages", "cluster",
                                           "grid")},
                w_l2_bytes=plan["w_l2_bytes"], shard_identical=same)


def _time_row(name, layer, mod, kw, fn, plain, args, inputs, pairs, width,
              rows, library=None, **extra):
    """One kernel call at a recorded shape: its output against the plain
    version's, CUDA-event ms (5 launches after one warm-up), the plain
    version's ms (one call), the bound and, where ``library`` (see
    ``library_product``) is given, the ms of its PyTorch call of the same
    function and its error against the plain version.  A product (a row
    with a library call) runs for about a tenth of a millisecond, so one
    stall of the host between launches would move a mean of 5: its ms and
    the library's are over ``PRODUCT_REPS`` calls."""
    import torch

    out, ref = fn(*args), plain(*args)
    first = (lambda o: o[0]) if isinstance(out, tuple) else (lambda o: o)
    err, ok = (compare if name.startswith("fwd") else compare_grad)(
        first(out), first(ref), mod.precision)
    reps = 5 if library is None else PRODUCT_REPS
    ms = cuda_time_ms(lambda: fn(*args), reps=reps)
    plain_ms = cuda_time_ms(lambda: plain(*args), reps=1, warmup=0)
    if library is not None:
        call, extra["library_call"] = library(*args)
        extra["library_err"], _ = compare(call(), first(ref), mod.precision)
        extra["library_ms"] = cuda_time_ms(call, reps=reps)
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


def phase_times(calls, per_step, **tag):
    """Forward rows from the serve phase's calls; dW and dX rows from the
    train phase's (keys "dw_<walk>"), with g from a numpy seed and the
    launches per training step of each (kernel, layer); ``tag`` goes into
    every row."""
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
                                      centers_n, **split, **tag))
                rows.append(_time_row("fwd_product", layer, mod, kw,
                                      tk.conv_fwd_product,
                                      tk.conv_fwd_product_plain, pa,
                                      list(pa), 0.0, 0, centers_n,
                                      library=library_product, walk=walk,
                                      **product_design(tk.conv_fwd_product,
                                                       pa), **tag))
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
                    launches_per_step=per, **splits[kname[:2]], **tag))
            for kname, fn, plain, a, n, lib, walk_name in (
                    ("dw_product", tk.conv_dw_product,
                     tk.conv_dw_product_plain, (xbar, g2), centers_n,
                     library_dw_product, f"dw_product_{walk}"),
                    ("dx_product", tk.conv_dx_product,
                     tk.conv_dx_product_plain, (z, w), cands_n,
                     library_dx_product, f"dx_{walk}")):
                design = (product_design(fn, a) if kname == "dx_product"
                          else dw_design(*a))
                rows.append(_time_row(
                    kname, layer, mod, kw, fn, plain, a, list(a), 0.0, 0, n,
                    library=lib, walk=walk,
                    launches_per_step=per_step.get((walk_name, layer), 0.0),
                    **design, **tag))
    return rows


def counts_row(name, layer, radius, walk):
    """The counts kernel at one main-path shape: equal to its plain
    version and to a second launch, bit for bit, CUDA-event ms (5 launches
    after one warm-up, as every kernel row), the plain
    version's ms (one call) and the bound: the coordinates, the tile list
    and the counts moved once, against the walk's tested pairs at
    ``COUNTS_OPS_PER_PAIR`` f32 operations each."""
    import torch

    from pointwise_torch.kernels import pointwise_conv_cuda as tk

    ctr, pts, _, ptr, idx = walk
    out, again = tk.conv_counts(*walk), tk.conv_counts(*walk)
    ref = tk.conv_counts_plain(*walk)
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
               ok=bool(torch.equal(out, ref) and torch.equal(out, again)))
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
    from pointwise_torch.utils.runtime import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t_all = time.perf_counter()

    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    def phase(name, fn, *args):
        """``fn(*args)``, then a ``clock`` line with its wall seconds."""
        t0 = time.perf_counter()
        out = fn(*args)
        emit({"phase": "clock", "of": name, "call": fn.__name__,
              "wall_s": time.perf_counter() - t0})
        return out

    t0 = time.perf_counter()
    tk.build_libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in tk.LIBRARY["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln],
          "product": product_build_report(tk)})
    phase("parity", phase_parity, dev)
    phase("grad", phase_grad, dev)
    phase("ext", phase_ext, dev)
    os.makedirs(tk._BUILD_DIR, exist_ok=True)     # ignored by git
    with tempfile.TemporaryDirectory(dir=tk._BUILD_DIR) as workdir:
        launches, replies, served, model = phase("serve", phase_serve, dev,
                                                 workdir)
        trained, train_calls, per_step, ckpts = phase("train", phase_train,
                                                      dev, workdir)
        phase("train", phase_serve_trained, dev,
              ckpts[TRAIN_CONFIGS[0][0]])
        phase("eval", phase_eval, dev, ckpts)
        partseg_calls, partseg_per_step = phase("partseg", phase_partseg,
                                                dev, workdir)
        phase("batchnorm", phase_batchnorm, dev, workdir)
    phase("remat", phase_remat, dev)
    # each kernel's launches come from its own path: the forward's from the
    # serve phase, dX's from the training run of its walk
    for rec in trained.values():
        name = f"dx_{rec['walk']}"
        launches[name] = rec["launches"][name]
    for name in ("dw_product", "dx_product"):    # both training runs
        launches[name] = sum(rec["launches"][name] for rec in trained.values())
    phase("exact", phase_exact, dev)
    # the ring's launches: the served-scale split (a) for the CSR walk of
    # the external-counts forward, the 2-rank runs (b) for the rest
    ext_launches, served_part = phase("spatial", phase_spatial_served, dev,
                                      served[("fwd_csr", 3)])
    launches["fwd_ext_csr"] = ext_launches["fwd_ext_csr"]
    with tempfile.TemporaryDirectory(dir=tk._BUILD_DIR) as workdir:
        ring_launches, ring_calls = phase("spatial", phase_spatial_ranks,
                                          dev, workdir)
    # the Function's dW reads the forward's kept means: only the ring's
    # partials walk for dW, dense and CSR
    for k in ("counts_dense", "counts_csr", "fwd_ext_dense", "dw_dense",
              "dw_csr"):
        launches[k] = ring_launches[k]
    with tempfile.TemporaryDirectory(dir=tk._BUILD_DIR) as workdir:
        phase("serve_parallel", phase_serve_parallel, dev, workdir, smi,
              replies)
    phase("subblock", phase_subblock, dev)
    phase("tools", phase_tools, dev)
    t0 = time.perf_counter()
    calls = {k: v for k, v in served.items() if k[0] == "fwd_csr"}
    calls.update(dense_calls(dev, model))
    calls.update(train_calls)
    rows = phase_times(calls, per_step)
    rows += spatial_rows(served_part, ring_calls)
    # ShapeNetPart's kernels at its widest-radius layer (the most pairs),
    # held against their plain versions; the kernels line keeps the earlier
    # paths' shapes
    top = max(k[1] for k in partseg_calls)
    phase_times({("fwd_dense", top): partseg_calls[("dw_dense", top)],
                 ("dw_dense", top): partseg_calls[("dw_dense", top)]},
                partseg_per_step, path="shapenetpart")
    emit({"phase": "clock", "of": "times",
          "wall_s": time.perf_counter() - t0})
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
                                   "library_call", "tile", "w_l2_bytes")
               if k in top}})
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
