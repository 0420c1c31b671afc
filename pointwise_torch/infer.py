"""Large-scan streaming inference CLI: ``python -m pointwise_torch.infer``.

A port of infer.py.  Runs the segmentation net over an arbitrarily large
scene with exact overlap-save tiling (streaming.py): native grid-hash tile
partition, halo = receptive field, bucketed shapes.  The convs run in the
Hopper kernel on the card; ``--device cpu`` runs their plain PyTorch
version instead (tests, no card).

  python -m pointwise_torch.infer --config s3dis_synthetic --points 1000000
  python -m pointwise_torch.infer --serve < requests.txt
  python -m pointwise_torch.infer --params weights.npz --data-dir rooms/
  torchrun --nproc-per-node 4 -m pointwise_torch.infer --serve --dp --sp 2

``--dp`` shards each chunk of tile batches over every rank; ``--sp N``
also row-shards the resident scene over N ranks (the rest data-parallel).
Rank r of a torchrun launch computes on ``cuda:<LOCAL_RANK>``; without a
launcher ``--dp`` runs as one rank.  Every rank loads the scene and builds
the same schedule; only rank 0 prints, replies and writes.

Weights: ``--checkpoint-dir`` names a directory of the port's training
checkpoints (``python -m pointwise_torch.train --checkpoint-dir``; the
newest is served); ``--params`` names an ``.npz`` of JAX-layout arrays keyed
by flattened parameter path (see convert.py); with neither the weights are
random, made from a numpy seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from pointwise_torch.convert import load_segmenter, random_segmenter_params
from pointwise_torch.data import s3dis, synthetic
from pointwise_torch.kernels import pointwise_conv_cuda as _kernels
from pointwise_torch.models import PointwiseSegmenter
from pointwise_torch.parallel import launch
from pointwise_torch.parallel.mesh import all_reduce, broadcast_text
from pointwise_torch.streaming import stream_apply, stream_apply_layered
from pointwise_torch.train import get_config
from pointwise_torch.train.trainer import checkpoint_steps, load_checkpoint


def big_scene(n_points: int, seed: int = 0, num_classes: int = 5):
    """Procedural scene scaled to ~n_points (room area grows with N to keep
    realistic density)."""
    per_obj = 4096
    num_obj = max(2, int(n_points / (per_obj * 1.5)))
    room = max(4.0, float(np.sqrt(num_obj)) * 1.2)
    return synthetic.segmentation_scene(
        seed, num_objects=num_obj, points_per_obj=per_obj, room=room,
        num_classes=num_classes,
    )


def scene_features(cfg, xyz, rgb):
    """Training-convention input features: rgb (+ scene-normalized coords)."""
    if cfg.in_features == 3:
        return rgb
    mins = xyz.min(0)
    span = np.maximum(xyz.max(0) - mins, 1e-6)
    return np.concatenate([rgb, (xyz - mins) / span], axis=1)


def load_scene_file(path):
    """One room/scene file on the s3dis on-disk contract: .npy (N, >=6) =
    xyz, rgb [, label].  Returns (xyz f32, rgb f32 in [0,1], label|None)."""
    from pointwise_torch.utils.spatial import check_coordinates

    arr = np.load(path)
    if arr.ndim != 2 or arr.shape[1] < 6:
        raise ValueError(f"{path}: expected (N, >=6) array, got {arr.shape}")
    xyz = check_coordinates(arr[:, 0:3].astype(np.float32), name=path)
    rgb = arr[:, 3:6].astype(np.float32)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    lab = arr[:, 6].astype(np.int32) if arr.shape[1] > 6 else None
    return xyz, rgb, lab


def load_profiles(path):
    """Length-profile persistence (JSON {key: [tbs, [lengths...]]}).

    Keys are either a p0 bucket (int, small-tile groups) or a full padded
    schedule (tuple of ints, big-tile groups); tuples serialize as
    comma-joined strings."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        raw = json.load(f)

    def key(b):
        return (tuple(int(x) for x in b.split(","))
                if "," in b else int(b))

    return {key(b): (int(v[0]), tuple(int(x) for x in v[1]))
            for b, v in raw.items()}


def save_profiles(path, profiles):
    if not path:
        return

    def key(b):
        return ",".join(str(x) for x in b) if isinstance(b, tuple) else str(b)

    with open(path, "w") as f:
        json.dump({key(b): [v[0], list(v[1])] for b, v in profiles.items()},
                  f)


def load_trained(model, checkpoint_dir) -> int:
    """Load the newest trainer checkpoint of ``checkpoint_dir`` into
    ``model``; returns its step.  The JAX package's orbax checkpoints
    (numbered step directories) are not readable here and say so."""
    if not checkpoint_steps(checkpoint_dir):
        if os.path.isdir(checkpoint_dir) and any(
                e.isdigit() and os.path.isdir(os.path.join(checkpoint_dir, e))
                for e in os.listdir(checkpoint_dir)):
            raise NotImplementedError(
                f"{checkpoint_dir}: orbax checkpoints of the JAX package are "
                "not yet ported (export the params to an .npz and pass "
                "--params)")
        raise FileNotFoundError(f"no trainer checkpoint in {checkpoint_dir}")
    state = load_checkpoint(checkpoint_dir, map_location="cpu")
    model.load_state_dict(state["model"], strict=True)
    return int(state["step"])


def load_weights(model, load_jax, checkpoint_dir=None,
                 params_path=None) -> str | None:
    """Load ``model``'s weights from the newest trainer checkpoint of
    ``checkpoint_dir`` or from a JAX-layout ``.npz`` (through ``load_jax``,
    a convert.py loader); returns what was loaded, None with neither."""
    if checkpoint_dir and params_path:
        raise ValueError("pass --checkpoint-dir or --params, not both")
    if checkpoint_dir:
        step = load_trained(model, checkpoint_dir)
        return f"restored step {step} from {checkpoint_dir}"
    if params_path:
        with np.load(params_path) as z:
            load_jax(model, {k: z[k] for k in z.files})
        return f"loaded {params_path}"
    return None


def build_model(cfg, device, params_path=None, precision="bfloat16",
                seed=0, checkpoint_dir=None):
    """The locality-only segmenter of ``cfg`` on ``device`` (eval mode),
    with weights from the newest trainer checkpoint of ``checkpoint_dir``,
    a JAX-layout ``.npz`` or random from ``seed``."""
    model = PointwiseSegmenter(
        num_classes=cfg.num_classes, in_features=cfg.in_features,
        channels=cfg.channels, radii=cfg.radii, head_dims=cfg.head_dims,
        dropout_rate=cfg.dropout, norm=cfg.norm, impl=cfg.impl,
        precision=precision, use_global_context=False,  # locality => exact
        device=device)
    if not load_weights(model, load_segmenter, checkpoint_dir, params_path):
        load_segmenter(model, random_segmenter_params(
            cfg.in_features, cfg.num_classes, channels=cfg.channels,
            head_dims=cfg.head_dims, norm=cfg.norm, seed=seed))
    return model.eval()


def layered_apply(model):
    """``apply_fn`` of stream_apply_layered for ``model``."""
    def apply(pts, fts, cnt, sels, skips, lengths):
        with torch.inference_mode():
            return model.streaming_logits(pts, fts, cnt, sels, skips,
                                          lengths=lengths)
    return apply


def _load_request(req, cfg):
    """(xyz, features, labels or None, path of the prediction or None) of
    one serve request."""
    if req.startswith("synth:"):
        xyz, rgb, lab = big_scene(int(req.split(":", 1)[1]),
                                  num_classes=cfg.num_classes)
        out_path = None
    else:
        xyz, rgb, lab = load_scene_file(req)
        out_path = req[: -len(".npy")] + ".pred.npy" \
            if req.endswith(".npy") else req + ".pred.npy"
    return xyz, scene_features(cfg, xyz, rgb), lab, out_path


def _any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (a collective)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    return bool(all_reduce(t, mesh.group("world"), dist.ReduceOp.MAX))


def serve(args, cfg, model, requests=None, emit=None, mesh=None):
    """Keep-alive serving loop: warm once on a synthetic scene, then stream
    every request at the engine's steady state.

    Protocol (``requests``, default stdin -> ``emit``, default stdout JSONL):
    one request per line —
      ``<path>.npy``            infer the scene file, write <path>.pred.npy
      ``synth:<n>``             procedural n-point scene (measurement)
      ``quit``                  exit
    Each reply: {"scene", "n_points", "seconds", "pts_per_s", "load_s",
    "compiled", "new_programs", "compile_s", ...}; ``compiled`` says whether
    this request built or loaded the kernel library (``new_programs``
    libraries, ``compile_s`` seconds).  A bad request gets an error reply and
    the server keeps going.  ``--profile-file`` persists the streaming length
    profiles so a restarted server replays the same schedules.

    Under ``mesh`` every rank runs this loop: rank 0 reads ``requests`` and
    broadcasts each line (``quit`` and the end of input too); every rank
    loads the scene, and the ranks agree on a failure before the engine's
    first collective, so a request that fails to load on any rank gets one
    error reply and every rank keeps serving.  A failure inside the engine
    (a card out of memory, say) may strike one rank alone while the others
    wait in one of its collectives, so under a mesh it is raised: the
    launcher then takes every rank down instead of leaving them out of
    step.  Only rank 0 emits and writes (the predictions and the profile
    file); every rank keeps its own profiles, which stay equal because
    every rank builds the same schedules.

    Returns, per request served on this rank, {"scene", "n_points",
    "events"} (the engine's events of that request).
    """
    lead = mesh is None or mesh.rank == 0
    requests = sys.stdin if requests is None else requests
    if emit is None:
        def emit(rec):
            print(json.dumps(rec), flush=True)
    if not lead:
        def emit(rec):
            pass
    # every rank reads the file before its first collective, so rank 0
    # cannot have rewritten it yet
    profiles = load_profiles(args.profile_file)
    apply = layered_apply(model)

    def run(xyz, feats):
        loads, secs = _kernels.LIBRARY["loads"], _kernels.LIBRARY["seconds"]
        ev = {}
        out = stream_apply_layered(
            apply, xyz, feats, radii=cfg.radii, tile_size=args.tile_size,
            out_dim=cfg.num_classes, tile_batch=args.tile_batch,
            length_profiles=profiles, events=ev, device=args.device,
            mesh=mesh, scene_axis=_scene_axis(mesh))
        if lead:
            save_profiles(args.profile_file, profiles)
        ev["new_programs"] = _kernels.LIBRARY["loads"] - loads
        ev["compile_s"] = _kernels.LIBRARY["seconds"] - secs
        return out, ev

    def lines():
        """The requests, on every rank."""
        it = iter(requests)
        while True:
            req = None
            if lead:
                for line in it:
                    req = line.strip()
                    if req and not req.startswith("#"):
                        break
                else:
                    req = None
            if mesh is not None:
                req = broadcast_text(req, mesh.group("world"), mesh.device)
            if req is None or req == "quit":
                return
            yield req

    if args.warm_points > 0:
        t0 = time.time()
        xyz, rgb, _ = big_scene(args.warm_points, num_classes=cfg.num_classes)
        run(xyz, scene_features(cfg, xyz, rgb))
        emit({"ready": True, "warmup_s": round(time.time() - t0, 2),
              "warm_points": args.warm_points})
    else:
        emit({"ready": True})

    served = []
    for req in lines():
        failed = None
        t0 = time.time()
        try:
            xyz, feats, lab, out_path = _load_request(req, cfg)
        except Exception as e:  # keep serving on bad requests
            failed = e
        if mesh is not None and _any_rank(failed is not None, mesh) \
                and failed is None:
            failed = RuntimeError("the request failed on another rank")
        if failed is not None:
            emit({"scene": req, "error": repr(failed)[:200]})
            continue
        t_load = time.time() - t0
        t0 = time.time()
        try:
            logits, ev = run(xyz, feats)
        except Exception as e:
            if mesh is not None:
                raise       # the other ranks may be inside a collective
            emit({"scene": req, "error": repr(e)[:200]})
            continue
        dt = time.time() - t0
        served.append({"scene": req, "n_points": len(xyz), "events": ev})
        try:
            pred = logits.argmax(axis=1).astype(np.int32)
            rec = {"scene": req, "n_points": len(xyz),
                   "seconds": round(dt, 3),
                   "pts_per_s": round(len(xyz) / dt),
                   "load_s": round(t_load, 3),
                   "compiled": ev["new_programs"] > 0,
                   "new_programs": int(ev["new_programs"]),
                   "compile_s": round(float(ev["compile_s"]), 2),
                   "phases": {k: v for k, v in ev.items()
                              if k.endswith("_s") and k != "compile_s"}}
            if out_path and lead:
                np.save(out_path, pred)
                rec["output"] = out_path
            if lab is not None:
                m = s3dis.iou_metrics(pred, lab, cfg.num_classes)
                rec["accuracy"] = round(m["accuracy"], 4)
                rec["miou"] = round(m["miou"], 4)
            emit(rec)
        except Exception as e:  # keep serving on bad requests
            emit({"scene": req, "error": repr(e)[:200]})
    return served


def _scene_axis(mesh):
    return "space" if mesh is not None and mesh.space > 1 else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="s3dis_synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--params", default=None,
                    help="JAX-layout weights (.npz keyed by flattened param "
                         "path); random weights from a seed when omitted")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="serve the newest checkpoint that "
                         "python -m pointwise_torch.train wrote here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--points", type=int, default=1_000_000,
                    help="synthetic scene size when no data dir given")
    ap.add_argument("--tile-size", type=float, default=4.0)
    ap.add_argument("--tile-batch", type=int, default=4)
    ap.add_argument("--layered", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="layer-wise shrinking halos (exact; faster)")
    ap.add_argument("--save-ply", default=None,
                    help="write class-colored predictions as binary PLY")
    ap.add_argument("--repeat", type=int, default=1,
                    help="stream the scene N times and report each pass")
    ap.add_argument("--serve", action="store_true",
                    help="keep-alive serving loop: warm once, then stream "
                         "scenes from stdin requests (see serve())")
    ap.add_argument("--warm-points", type=int, default=200_000,
                    help="--serve warm-up scene size (0 disables)")
    ap.add_argument("--profile-file", default=None,
                    help="persist streaming length profiles (JSON)")
    ap.add_argument("--dp", action="store_true",
                    help="shard tile batches over every rank (torchrun; one "
                         "rank without a launcher)")
    ap.add_argument("--sp", type=int, default=1,
                    help="also row-shard the device-resident scene over a "
                         "'space' axis of this many ranks (scans beyond one "
                         "card's memory; composes with --dp)")
    ap.add_argument("--norm", default=None, choices=["layer", "batch", "none"],
                    help="override the config's normalization — must match "
                         "the weights' training flag")
    return ap.parse_args(argv)


def main(argv=None, mesh=None, requests=None, emit=None):
    """Run the CLI.  ``mesh``: run as this rank of an existing mesh (on its
    device) instead of building one from the launcher's environment for
    ``--dp`` / ``--sp``; ``requests`` / ``emit``: the input and output of
    ``--serve`` (default stdin and stdout JSONL), which returns what
    ``serve`` returns."""
    args = parse_args(argv)
    if (mesh is not None or args.dp or args.sp > 1) and not args.layered:
        raise ValueError("--dp / --sp shard the layered engine only (drop "
                         "--no-layered)")
    device, mesh = launch.resolve_rank(args.device, args.dp, args.sp, mesh,
                                       "pointwise_torch.infer")
    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.config)
    if args.norm:
        cfg = dataclasses.replace(cfg, norm=args.norm)
    model = build_model(cfg, device, args.params,
                        checkpoint_dir=args.checkpoint_dir)
    if mesh is not None and lead:
        print(f"# tile batches over data:{mesh.data}"
              + (f", scene rows over space:{mesh.space}"
                 if mesh.space > 1 else ""), flush=True)

    if args.serve:
        if not args.layered:
            raise SystemExit("--serve supports only the layered engine "
                             "(drop --no-layered)")
        return serve(args, cfg, model, requests, emit, mesh)

    if args.data_dir:
        xyz, rgb, lab = s3dis.load_rooms(args.data_dir)[0]
    else:
        t0 = time.time()
        xyz, rgb, lab = big_scene(args.points, num_classes=cfg.num_classes)
        if lead:
            print(f"# scene: {len(xyz)} pts in {time.time()-t0:.1f}s",
                  flush=True)
    feats = scene_features(cfg, xyz, rgb)

    halo = float(sum(cfg.radii))
    t0 = time.time()
    prog = lambda d, t, b: print(  # noqa: E731
        f"# tiles {d}/{t} (bucket {b}) {time.time()-t0:.1f}s", flush=True
    ) if lead and (d % 64 == 0 or d == t) else None
    profiles = load_profiles(args.profile_file)
    for rep in range(max(1, args.repeat)):
        t0 = time.time()
        if args.layered:
            logits = stream_apply_layered(
                layered_apply(model), xyz, feats, radii=cfg.radii,
                tile_size=args.tile_size, out_dim=cfg.num_classes,
                tile_batch=args.tile_batch,
                progress=prog if rep == 0 else None,
                length_profiles=profiles, device=device, mesh=mesh,
                scene_axis=_scene_axis(mesh))
            if rep == 0 and lead:
                save_profiles(args.profile_file, profiles)
        else:
            def apply_fn(pts, fts, mask):
                with torch.inference_mode():
                    return model(pts, fts, mask)

            logits = stream_apply(
                apply_fn, xyz, feats, halo=halo, tile_size=args.tile_size,
                out_dim=cfg.num_classes, tile_batch=args.tile_batch,
                progress=prog if rep == 0 else None, device=device)
        dt_rep = time.time() - t0
        if args.repeat > 1 and lead:
            print(f"# pass {rep}: {dt_rep:.2f}s -> "
                  f"{len(xyz)/dt_rep:.0f} pts/s", flush=True)
    dt = time.time() - t0   # with --repeat > 1: the LAST pass
    if not lead:
        return
    pred = logits.argmax(axis=1).astype(np.int32)
    if args.save_ply:
        from pointwise_torch.utils.ply import write_ply

        write_ply(args.save_ply, xyz, labels=pred)
        print(f"# wrote {args.save_ply} ({len(xyz)} pts, class-colored)",
              flush=True)
    rec = {
        "metric": "streaming_points_per_sec",
        "value": round(len(xyz) / dt),
        "unit": "points/s",
        "n_points": len(xyz),
        "seconds": round(dt, 2),
        "halo": halo,
        "layered": bool(args.layered),
        "device": str(device),
    }
    if args.repeat > 1:
        rec["passes"] = args.repeat   # value/seconds describe the last pass
    if lab is not None and not args.data_dir:
        m = s3dis.iou_metrics(pred, lab, cfg.num_classes)
        rec["accuracy"] = round(m["accuracy"], 4)
        rec["miou"] = round(m["miou"], 4)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
