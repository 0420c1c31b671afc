"""The forward's means walk split into its parts, from an instrumented copy.

    python -m pointwise_torch.tools.walk_split
        [--points 1000000 200000] [--layers 0 2]
    python -m pointwise_torch.tools.walk_split --blocks 8 \
        --config s3dis_synthetic_local --layers 0 1 2 3
    python -m pointwise_torch.tools.walk_split --shapes 32 \
        --config shapenetpart --layers 0 5
    python -m pointwise_torch.tools.walk_split --device cpu \
        --config seg_tiny_stream --points 3000 --layers 0 1

Serves each ``synth:<n>`` request of ``--points`` through the streaming
engine (``--config``, numpy-seeded weights, bf16) with a forward hook that
keeps, per conv layer, the inputs of its largest call (the conv layer's
index is the index of its radius in the config's radii); with
``--blocks B`` it runs the config's segmenter once on its first B
training blocks instead (``s3dis.training_blocks``, the training step's
morton-sorted blocks of ``num_points``), and with ``--shapes B`` on B
synthetic part-segmentation shapes of ``num_points``, xyz as features
(``shapenetpart.load_shapenetpart``, morton-sorted: the part segmenter's
trunk convs see the same points, widths and radii).  Then, for each layer
of ``--layers``:

- ``ms``: the card ms of ``conv_fwd_means`` (the main path's walk, CSR
  or dense as the op chose; CUDA events over ``REPS`` calls after one
  warm-up, its feature pack included);
- the instrumented copy, csrc/pointwise_conv_walk_split.cu: the same
  kernel source built with ``PW_WALK_SPLIT`` (``nvcc`` into
  ``kernels/_build/walk_split/``; the kernel module never builds it), run
  once after one warm-up.  Each warp stamps ``clock()`` at the boundaries
  of its loop's parts and adds each part's cycles into a counter summed
  over warps: ``codes`` (pair_code into the shared code bytes, the live
  k-steps), ``stage`` (issuing the cp.async copies of features and
  coordinates), ``wait`` (cp.async.wait_all and the two __syncthreads of
  an iteration), ``tests`` (the per-cell compares, __any_sync and the
  planes' masks), ``mma`` (ldmatrix and mma.sync), ``epilogue`` (the
  means and their stores), ``cull`` (the rows' box and the box tests of
  the listed k-steps).  ``share``: each part's cycles over all warps'
  cycles; ``instrumented_ms`` its card ms (the stamps' own cost shows as
  the gap to ``ms``); its xbar and counts must equal the main kernel's
  bit for bit, or the tool raises;
- ``cull_share``: the share of the listed k-steps that the forward's (and
  dW's) walk keeps, from the plain ``walk_cull_share`` (not with
  ``--no-split``); on the card ``ksteps``, the k-steps the instrumented
  walk's CTAs kept and listed, whose ratio must equal ``cull_share``, or
  the tool raises.

One JSON record per (request, layer), with the card's name and power
limit.  ``--no-split`` times the main walk alone (nothing is built): run
as a file with ``PYTHONPATH`` at an older tree's copy, it times that
tree's walk on the same inputs.  On the CPU (``--device cpu``) the plain
walk runs, nothing is built, and every time and share is "not measured".
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess

import torch

from pointwise_torch import infer, resolve_device
from pointwise_torch.data import s3dis, shapenetpart
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.models.layers import PointwiseConv
from pointwise_torch.ops.pointwise_conv import conv_layout, csr_walk
from pointwise_torch.train import get_config
from pointwise_torch.utils.runtime import (NOT_MEASURED, event_ms,
                                           nvidia_smi_line)

PARTS = ("codes", "stage", "wait", "tests", "mma", "epilogue", "cull")
SOURCE = "pointwise_conv_walk_split.cu"
BUILD_DIR = os.path.join(tk._BUILD_DIR, "walk_split")
REPS = 5


def build():
    """Build the instrumented walk (once per source hash) and load it."""
    h = hashlib.sha1(" ".join(tk._NVCC_FLAGS + tk._NVCC_LIBS).encode())
    for name in (SOURCE, *tk._HEADERS):
        with open(os.path.join(tk._CSRC, name), "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"walk_split-{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp.{os.getpid()}"
        out = subprocess.run(
            [tk._nvcc(), *tk._NVCC_FLAGS, "-o", tmp,
             os.path.join(tk._CSRC, SOURCE), *tk._NVCC_LIBS],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout[-4000:]}"
                               f"{out.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pw_split_fwd_means.argtypes = [vp] * 8 + [ci] * 5 + [cf, cf, vp]
    lib.pw_split_read.argtypes = [vp]
    lib.pw_split_read_ksteps.argtypes = [vp]
    if lib.pw_split_parts() != len(PARTS):
        raise RuntimeError(f"the kernel has {lib.pw_split_parts()} parts, "
                           f"not {len(PARTS)}")
    return lib


def capture(cfg_name, points, dev, blocks=0, shapes=0):
    """Serve ``synth:<n>`` for each n of ``points``, or with ``blocks`` /
    ``shapes`` run the segmenter on that many training blocks / shapes;
    returns {(request, layer): (module, conv inputs)} of each layer's
    largest call, the request ``synth:<n>``, ``blocks:<B>x<num_points>``
    or ``shapes:<B>x<num_points>``."""
    args = infer.parse_args(["--serve", "--config", cfg_name, "--device",
                             dev.type, "--warm-points", "0"])
    cfg = get_config(cfg_name)
    model = infer.build_model(cfg, dev)
    calls, current = {}, [""]

    def hook(mod, inputs, out):
        if not isinstance(mod, PointwiseConv):
            return
        key = (current[0], list(cfg.radii).index(mod.radius))
        pts, x, mask, centers, cmask = (list(inputs) + [None] * 5)[:5]
        size = pts.shape[0] * pts.shape[1] * (
            pts if centers is None else centers).shape[1]
        if size > calls.get(key, (0,))[0]:
            calls[key] = (size, mod, (pts, x, mask, centers, cmask))

    def emit(rec):
        if "error" in rec:
            raise RuntimeError(f"serving failed: {rec}")

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        if blocks:
            data = s3dis.training_blocks(cfg)
            t = lambda k: torch.from_numpy(data[k][:blocks]).to(dev)  # noqa
            current[0] = f"blocks:{blocks}x{cfg.num_points}"
            with torch.inference_mode():
                model(t("points"), t("features"), t("mask"))
        if shapes:
            data = shapenetpart.load_shapenetpart(
                None, n_points=cfg.num_points, synthetic_size=shapes)
            current[0] = f"shapes:{shapes}x{cfg.num_points}"
            with torch.inference_mode():
                model(torch.from_numpy(data.points).to(dev))
        for n in ([] if blocks or shapes else points):
            current[0] = f"synth:{n}"
            infer.serve(args, cfg, model, requests=[current[0]], emit=emit)
    finally:
        handle.remove()
    return {k: v[1:] for k, v in calls.items()}


def split_layer(lib, mod, inputs, dev) -> dict:
    """One layer's record (see the module docstring)."""
    points, x, mask, centers, cmask = inputs
    with torch.inference_mode():
        kw, _ = conv_layout(points, x, mod.kernel, mod.bias,
                            radius=mod.radius, mask=mask, centers=centers,
                            center_mask=cmask, precision=mod.precision)
    ctr, pts, feats = kw["ctr"], kw["pts"], kw["feats"]
    ptr, idx, radius = kw["tile_ptr"], kw["tile_idx"], kw["radius"]
    B, Ncp, Mp, cin = ctr.shape[0], ctr.shape[1], pts.shape[1], feats.shape[2]
    means = (ctr, pts, feats, radius, ptr, idx)
    xbar, cnt = tk.conv_fwd_means(*means)
    rec = dict(layer_radius=radius, walk="dense" if idx is None else "csr",
               B=B, Ncp=Ncp, Mp=Mp, cin=cin, tiles_listed=(
                   B * (Ncp // tk.TILE) * (Mp // tk.TILE) if idx is None
                   else int(idx.numel())),
               pairs=float(cnt.sum()), precision=mod.precision)
    if dev.type != "cuda" or lib is not None:
        rec["cull_share"] = tk.walk_cull_share(ctr, pts, radius, ptr, idx)
    if dev.type != "cuda":
        return dict(rec, ms=NOT_MEASURED, instrumented_ms=NOT_MEASURED,
                    cycles=NOT_MEASURED, share=NOT_MEASURED,
                    ksteps=NOT_MEASURED)
    ms = event_ms(lambda: tk.conv_fwd_means(*means), REPS)
    if lib is None:
        return dict(rec, ms=ms)
    if feats.dtype != torch.bfloat16:
        raise ValueError("the instrumented walk takes bf16 features")
    k = tk.N_CELLS * cin
    ldx = tk.round_up(k, 8)
    out = torch.empty((B * Ncp, ldx), dtype=feats.dtype, device=dev)
    cnt2 = torch.empty_like(cnt)
    main = tk.build_libraries()["pointwise_conv_fwd"]
    packed = tk._pack_scratch(main.pw_conv_pack_elems, cin, 1, B, Mp, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = lib.pw_split_fwd_means(
            ctr.data_ptr(), pts.data_ptr(), feats.data_ptr(),
            packed.data_ptr(), tk._ptr(ptr), tk._ptr(idx), cnt2.data_ptr(),
            out.data_ptr(), ldx, B, Ncp, Mp, cin, float(radius),
            tk._inv_cell(radius), stream)
        if err != 0:
            raise RuntimeError(f"pw_split_fwd_means: cudaError {err}")

    run()
    torch.cuda.synchronize(dev)
    if lib.pw_split_reset() != 0:
        raise RuntimeError("pw_split_reset failed")
    inst_ms = event_ms(run, 1, warmup=0)
    cycles = (ctypes.c_ulonglong * len(PARTS))()
    ksteps = (ctypes.c_ulonglong * 2)()
    if lib.pw_split_read(ctypes.addressof(cycles)) != 0 \
            or lib.pw_split_read_ksteps(ctypes.addressof(ksteps)) != 0:
        raise RuntimeError("pw_split_read failed")
    if not (torch.equal(out[:, :k], xbar) and torch.equal(cnt2, cnt)):
        raise AssertionError("the instrumented walk's means or counts "
                             "differ from the main kernel's")
    kept, listed = int(ksteps[0]), int(ksteps[1])
    if (kept / listed if listed else 1.0) != rec["cull_share"]:
        raise AssertionError(f"the instrumented walk kept {kept} of {listed} "
                             f"k-steps, not a share of {rec['cull_share']}")
    total = sum(cycles)
    return dict(rec, ms=ms, instrumented_ms=inst_ms,
                cycles=dict(zip(PARTS, (int(c) for c in cycles))),
                share={p: c / total for p, c in zip(PARTS, cycles)},
                ksteps=dict(kept=kept, listed=listed))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.walk_split")
    ap.add_argument("--config", default="s3dis_synthetic")
    ap.add_argument("--points", type=int, nargs="+",
                    default=[1_000_000, 200_000])
    ap.add_argument("--layers", type=int, nargs="+", default=[0, 2])
    ap.add_argument("--blocks", type=int, default=0,
                    help="run the segmenter on this many training blocks "
                         "in place of the served requests")
    ap.add_argument("--shapes", type=int, default=0,
                    help="run the segmenter on this many synthetic "
                         "part-segmentation shapes in place of the served "
                         "requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--no-split", dest="split", action="store_false",
                    help="time the main walk only; build nothing")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Split every (request, layer); returns the printed records."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    lib = build() if dev.type == "cuda" and args.split else None
    card = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    calls = capture(args.config, args.points, dev, args.blocks, args.shapes)
    recs = []
    for req in dict.fromkeys(key[0] for key in calls):
        for layer in args.layers:
            mod, inputs = calls[(req, layer)]
            rec = dict(request=req, layer=layer, card=card,
                       csr_by_op=csr_walk(inputs[0].shape[1]),
                       **split_layer(lib, mod, inputs, dev))
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
