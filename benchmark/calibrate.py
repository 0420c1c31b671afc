"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's own runs):

  python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... [--faults 3]

For each seed, in one process: the program's readings (a run of the cell
with a window just long enough for the requests or steps it checks), the
precision control's (the reference computed in fp8 in the program's
place, benchmark/reference/precision.py) and, for the first ``--faults``
seeds, the readings of the program with a fault planted: a served answer
altered where it is produced, or half of a training batch left out.  A
training step that returns its state unchanged reads 1 by the change's
measure and needs no run.  For the first ``--witness`` seeds of a serving
cell, the look behind the served gap (``witness_readings``).  One JSON
line per seed and reading.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import numpy as np
import torch

from benchmark import cell, check, traffic, weights
from benchmark.reference import models as ref_models
from benchmark.reference.precision import round_fp8


@contextlib.contextmanager
def answer_altered():
    """The streaming engine's logits of one point replaced by another
    point's."""
    from pointwise_torch import streaming

    real = streaming.stream_apply_layered

    def altered(*a, **k):
        out = real(*a, **k)
        out[0] = out[len(out) // 2]
        return out

    streaming.stream_apply_layered = altered
    try:
        yield
    finally:
        streaming.stream_apply_layered = real


@contextlib.contextmanager
def half_batch():
    """Every training step given the first half of its batch only (its
    loss the mean over that half)."""
    from pointwise_torch.train.trainer import Trainer

    real = Trainer.step

    def half(self, batch, seed):
        return real(self, {k: v[:len(v) // 2] for k, v in batch.items()},
                    seed)

    Trainer.step = half
    try:
        yield
    finally:
        Trainer.step = real


def control_readings(workload: str, seed: int, device="cuda") -> dict:
    """The compared numbers of the precision control against the
    reference, on what a short run of ``workload`` checks."""
    from benchmark import train as train_loop

    bench = cell.load_benchmark()
    c, centry = cell.find(bench, workload)
    cfg = cell.load_json(cell.ROOT, centry["file"])
    mix = traffic.load(c["traffic"])
    dev = torch.device(device)
    rnd = round_fp8
    if mix["kind"] == "serve":
        w = weights.make(cfg, cfg["in_features"], sum(cfg["channels"]),
                         traffic.sub_seed(seed, 1), dev)
        scenes = traffic.base_scenes(cfg, mix, seed)
        worst: dict = {}
        with ref_models.float32_exact():
            for idx in range(mix["check_scans"]):
                xyz, feats = traffic.scan_request(cfg, mix, scenes, seed, idx)
                x = torch.from_numpy(xyz).to(dev)
                f = torch.from_numpy(feats).to(dev)
                ref = ref_models.segmenter_scene_logits(w, cfg["radii"], x, f)
                low = ref_models.segmenter_scene_logits(w, cfg["radii"], x, f,
                                                        rnd=rnd)
                for k, v in check.logit_gaps(low, ref).items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst
    cin, head_in = train_loop._net_inputs(cfg)
    w = weights.make(cfg, cin, head_in, traffic.sub_seed(seed, 1), dev)
    pool = traffic.batch_pool(cfg, mix, seed)
    n = mix["first_steps"]
    ref = train_loop.reference_steps(cfg, pool, seed, w, n, dev)
    low = train_loop.reference_steps(cfg, pool, seed, w, n, dev, rnd=rnd)
    return check.training_gaps(low, ref)


def witness_readings(workload: str, seed: int, device="cuda") -> dict:
    """Where the served logits of a serving cell's first request depart
    from the reference's.  ``abs_*``: the program against the reference
    over the scene's own coordinates, as the check compares them.
    ``tile_*``: the program against the reference fed, for the points of
    each of the engine's tiles, the whole scene less that tile's centre in
    float32, the coordinates the engine computes in.  ``moved_*``: the
    reference over the scene less the first tile's centre against itself
    over the scene's own coordinates.  Where ``tile_*`` reads what the
    program reads on exactly represented coordinates and ``moved_*``
    reads about ``abs_*``, the gap is the rounding of the coordinates
    (in-ball and cell ties), not the engine."""
    from pointwise_torch import infer, streaming
    from pointwise_torch.native import GridIndex

    bench = cell.load_benchmark()
    c, centry = cell.find(bench, workload)
    cfg = cell.load_json(cell.ROOT, centry["file"])
    mix = traffic.load(c["traffic"])
    dev = torch.device(device)
    w = weights.make(cfg, cfg["in_features"], sum(cfg["channels"]),
                     traffic.sub_seed(seed, 1), dev)
    model = infer.build_model(cell.port_config(cfg), dev,
                              precision=cfg["precision"])
    model.load_state_dict(w, strict=True)
    scenes = traffic.base_scenes(cfg, mix, seed)
    xyz, feats = traffic.scan_request(cfg, mix, scenes, seed, 0)
    port = torch.as_tensor(streaming.stream_apply_layered(
        infer.layered_apply(model), xyz, feats, radii=cfg["radii"],
        tile_size=mix["tile_size"], out_dim=cfg["num_classes"],
        tile_batch=mix["tile_batch"], length_profiles={}, device=dev),
        device=dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    x, f = torch.from_numpy(xyz).to(dev), torch.from_numpy(feats).to(dev)
    grid = GridIndex(xyz, mix["tile_size"])
    out = {}
    with ref_models.float32_exact():
        ref = ref_models.segmenter_scene_logits(w, cfg["radii"], x, f)
        tiled, moved = torch.full_like(ref, float("nan")), None
        for cc in grid.nonempty_cells():
            inner = grid.cell_points(cc)
            if len(inner) == 0:
                continue
            lo = grid.origin + cc.astype(np.float32) * mix["tile_size"]
            centre = torch.from_numpy(
                np.asarray(lo + 0.5 * mix["tile_size"], np.float32)).to(dev)
            r = ref_models.segmenter_scene_logits(w, cfg["radii"],
                                                  x - centre, f)
            idx = torch.from_numpy(np.asarray(inner, np.int64)).to(dev)
            tiled[idx] = r[idx]
            moved = r if moved is None else moved
    for name, a, b in (("abs", port, ref), ("tile", port, tiled),
                       ("moved", moved, ref)):
        out.update({f"{name}_{k}": v
                    for k, v in check.logit_gaps(a, b).items()})
    out["tiles"] = len(grid.nonempty_cells())
    return out


def main(argv=None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--controls", type=int, default=None,
                    help="seeds that also read the control (default all)")
    ap.add_argument("--witness", type=int, default=0,
                    help="serving cells: seeds that also read "
                         "witness_readings")
    args = ap.parse_args(argv)
    run._fixed_caches()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    kind = traffic.load(cell.find(cell.load_benchmark(),
                                  args.workload)[0]["traffic"])["kind"]
    fault = answer_altered if kind == "serve" else half_batch

    def emit(seed, what, checks):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": what,
                          "values": {k: (v["value"] if isinstance(v, dict)
                                         else v)
                                     for k, v in checks.items()}}),
              flush=True)

    for i, seed in enumerate(args.seeds):
        out = run.execute(args.workload, seed, 0.0, False, "cuda")
        emit(seed, "program", out["checks"])
        if args.controls is None or i < args.controls:
            emit(seed, "fp8", control_readings(args.workload, seed))
        if kind == "serve" and i < args.witness:
            emit(seed, "witness", witness_readings(args.workload, seed))
        if i < args.faults:
            with fault():
                out = run.execute(args.workload, seed, 0.0, False, "cuda")
            emit(seed, fault.__name__, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
