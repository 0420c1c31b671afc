"""Forward, dW and dX of each conv layer at the segmentation shapes.

    python -m pointwise_torch.tools.sweep_seg_conv [--quick]
    python -m pointwise_torch.tools.sweep_seg_conv --quick --batch 1 \
        --points 256 --device cpu

A port of scripts/sweep_seg_conv.py.  For each layer's (radius, cin,
cout) of the segmentation trunk (4 x 124, radii 0.1-0.8, 6 input features)
it times the op on real geometry, the first ``--batch`` morton-sorted
blocks of ``s3dis.training_blocks`` at ``--points`` per block, bf16:
``fwd`` the forward, ``dW`` the forward and the weight gradient of
sum(y * y), ``dX`` the forward and the feature gradient (what ``jax.grad``
of the loss runs), each as card ms per call from CUDA events over
``--iters`` calls after one warm-up.  Walks: ``auto`` (the op's choice
from the candidate count), and without ``--quick`` also ``csr`` and
``dense`` forced, so the walk choice at N = 4096 is measured.  The JAX
script's ``tile_m`` sweep sets a TPU tile size and has no counterpart
here.  One JSON record per (layer, walk); on the CPU the ms say "not
measured".
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pointwise_torch import resolve_device
from pointwise_torch.data import s3dis
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.ops.pointwise_conv import csr_walk
from pointwise_torch.train.configs import SegmentationConfig
from pointwise_torch.utils.runtime import NOT_MEASURED, event_ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.sweep_seg_conv")
    ap.add_argument("--quick", action="store_true",
                    help="the op's own walk choice only")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the sweep; returns the printed records."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    B, N = args.batch, args.points
    cfg = SegmentationConfig(name="sweep", num_classes=5, batch_size=B,
                             num_points=N)
    blocks = s3dis.training_blocks(cfg)
    pts = torch.from_numpy(blocks["points"][:B]).to(dev)
    mask = torch.from_numpy(blocks["mask"][:B]).to(dev)
    print(f"# B={B} N={N} block_size={cfg.block_size} radii={cfg.radii} "
          f"channels={cfg.channels} device={dev}", flush=True)
    walks = [("auto", None)]
    if not args.quick:
        walks += [("csr", True), ("dense", False)]
    rng = np.random.RandomState(0)
    recs = []
    cin = cfg.in_features
    for layer, (radius, cout) in enumerate(zip(cfg.radii, cfg.channels)):
        feats = torch.from_numpy(rng.standard_normal((B, N, cin)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.1)
                             .astype(np.float32)).to(dev)
        for name, csr in walks:
            kw = dict(radius=radius, mask=mask, precision="bfloat16",
                      csr=csr)

            def fwd(kw=kw):
                with torch.no_grad():
                    return pointwise_conv(pts, feats, w, None, **kw)

            def grad(of_w, kw=kw):
                f = feats.detach().requires_grad_(not of_w)
                wt = w.detach().requires_grad_(of_w)
                y = pointwise_conv(pts, f, wt, None, **kw).float()
                (y * y).sum().backward()
                return wt.grad if of_w else f.grad

            rec = dict(layer=layer, radius=radius, cin=cin, cout=cout,
                       walk=name, csr=csr_walk(N, csr), batch=B, points=N)
            for tag, fn in (("fwd", fwd), ("dW", lambda: grad(True)),
                            ("dX", lambda: grad(False))):
                if dev.type == "cuda":
                    rec[f"{tag}_ms"] = event_ms(fn, reps=args.iters)
                else:
                    fn()
                    rec[f"{tag}_ms"] = NOT_MEASURED
            if dev.type == "cuda":
                rec["sum_ms"] = rec["fwd_ms"] + rec["dW_ms"] + rec["dX_ms"]
            print(json.dumps(rec), flush=True)
            recs.append(rec)
        cin = cout
    return recs


if __name__ == "__main__":
    main()
