"""A served scene split into host phases and device time.

    python -m pointwise_torch.tools.attribute_streaming --points 1000000
    python -m pointwise_torch.tools.attribute_streaming --points 200000
    python -m pointwise_torch.tools.attribute_streaming --config \
        seg_tiny_stream --points 3000 --device cpu

A port of scripts/attribute_streaming.py.  The serving path of ``python -m
pointwise_torch.infer`` (``infer.big_scene``, ``infer.build_model``: the
config's locality-only segmenter with the weights of its seed,
``infer.layered_apply``) streams one scene three times:

  warm    first use (allocator, kernel libraries, length profiles);
  steady  the engine's phase timers only (its ``events``: schedule build,
          packer, dispatch, fetch, scatter, wait on the packer);
  traced  the same under torch.profiler: the device's busy seconds (the
          union of its busy intervals) and idle share of the pass
          (skipped with ``--no-trace``).

Each pass prints one JSON record, so host-bound, device-bound and
padding-bound are measured, not guessed.  Without device time (the CPU)
the traced pass says "not measured".
"""

from __future__ import annotations

import argparse
import json
import time

from pointwise_torch import infer, resolve_device
from pointwise_torch.streaming import stream_apply_layered
from pointwise_torch.train import get_config
from pointwise_torch.utils.runtime import NOT_MEASURED, device_seconds, profile


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.attribute_streaming")
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--tile-size", type=float, default=4.0)
    ap.add_argument("--tile-batch", type=int, default=4)
    ap.add_argument("--config", default="s3dis_synthetic")
    ap.add_argument("--logdir", default=None,
                    help="write the traced pass's chrome trace here")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the tool; returns the printed records."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    xyz, rgb, _ = infer.big_scene(args.points, num_classes=cfg.num_classes)
    feats = infer.scene_features(cfg, xyz, rgb)
    apply = infer.layered_apply(infer.build_model(cfg, dev))

    def one_pass(tag):
        ev = {}
        t0 = time.perf_counter()
        stream_apply_layered(apply, xyz, feats, radii=cfg.radii,
                             tile_size=args.tile_size,
                             out_dim=cfg.num_classes,
                             tile_batch=args.tile_batch, events=ev,
                             device=dev)
        wall = time.perf_counter() - t0     # the logits are on the host
        return dict({"pass": tag, "n_points": len(xyz), "wall_s": wall,
                     "pts_per_s": len(xyz) / wall}, **ev)

    recs = [one_pass("warm"), one_pass("steady")]
    if not args.no_trace:
        with profile(args.logdir, device=dev) as prof:
            rec = one_pass("steady_traced")
        busy = device_seconds(prof)
        if busy > 0:
            rec.update(device_s=busy,
                       device_idle_share=1.0 - busy / rec["wall_s"])
        else:
            rec["device_s"] = NOT_MEASURED
        recs.append(rec)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
