"""The voting loop: a closed loop of one client handing whole rooms to the
program's evaluation path, one at a time, which labels each by
sliding-block overlap voting with the segmenter's global pool.

Entry driven: ``s3dis.predict_scene_voting`` with
``eval.block_predictor(cli.build_segmenter(...))``, as ``python -m
pointwise_torch.eval --config s3dis`` calls them.  A room is the serving
cells' 196,608-point room, turned and moved by ``traffic.scan_request``;
its latency runs from handing it over to its labels and votes on the
host.  The record is a serving record (kind ``serve``), so the serving
readers read it; each request's ``events`` are the voting path's own.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import cell, check, devtrace, traffic, weights, work
from benchmark.reference import models as ref_models
from benchmark.reference import vote as ref_vote
from benchmark.reference.precision import round_fp8
from benchmark.serve import sample


def head_in(cfg) -> int:
    """The head's input width: every block and the last one's max and
    mean."""
    return sum(cfg["channels"]) + 2 * cfg["channels"][-1]


def room_request(cfg, mix, scenes, seed, index, warm=False):
    """(xyz, rgb) of room ``index``: ``traffic.scan_request``'s turn and
    shift of its base room, the colours as they are (the voting path
    makes its own features)."""
    xyz, _ = traffic.scan_request(cfg, mix, scenes, seed, index, warm=warm)
    return xyz, scenes[index % len(scenes)][1]


def _voting(cfg, mix):
    return dict(num_classes=cfg["num_classes"], num_points=cfg["num_points"],
                block_size=cfg["block_size"], stride=mix["stride"],
                batch_size=cfg["batch_size"], feature_mode="rgb_norm")


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, limits: dict, log) -> dict:
    """One run; returns the record the metric readers read."""
    from pointwise_torch import eval as port_eval
    from pointwise_torch.data import s3dis
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels
    from pointwise_torch.train import cli

    predictor = port_eval.block_predictor   # a program without it stops here
    dev = torch.device(device)
    pcfg = cell.port_config(cfg)
    model = cli.build_segmenter(pcfg, dev)[0]
    precision = {blk.conv.precision for blk in model.blocks}
    if precision != {cfg["precision"]} or not model.use_global_context:
        raise ValueError(f"the program's net ({precision}, global context "
                         f"{model.use_global_context}) is not the "
                         f"configuration's")
    w = weights.make(cfg, cfg["in_features"], head_in(cfg),
                     traffic.sub_seed(seed, 1), dev)
    model.load_state_dict(w, strict=True)
    predict = predictor(model.eval(), dev)
    scenes = traffic.base_scenes(cfg, mix, seed)
    voting = _voting(cfg, mix)

    def label(xyz, rgb, events):
        with record_function("harness.predict_scene_voting"):
            return s3dis.predict_scene_voting(predict, xyz, rgb,
                                              events=events, **voting)

    for i in range(mix["warm_rooms"]):
        label(*room_request(cfg, mix, scenes, seed, i, warm=True), {})
    devtrace.sync(dev)
    setup_s = time.perf_counter() - t_start

    kernels.reset_launches()
    votes, requests, failed = {}, [], 0
    t0 = time.perf_counter()
    i = 0
    while True:
        xyz, rgb = room_request(cfg, mix, scenes, seed, i)
        ev = {}
        ts = time.perf_counter()
        try:
            votes[i] = label(xyz, rgb, ev)["votes"]
            te = time.perf_counter()
            requests.append(dict(index=i, latency_s=te - ts,
                                 points=len(xyz), events=ev))
        except Exception as e:  # a failed request counts, the loop goes on
            te = time.perf_counter()
            failed += 1
            log(f"room {i} failed: {e!r}"[:400])
        i += 1
        if te - t0 >= seconds and (len(requests) >= mix["check_rooms"]
                                   or failed):
            break
    rec = dict(kind="serve", setup_s=setup_s, window_s=te - t0,
               requests=requests, attempted=i, failed=failed,
               launches=dict(kernels.LAUNCHES))
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)

    traced = []
    if trace:
        def one(k):
            traced.append(i + k)
            label(*room_request(cfg, mix, scenes, seed, i + k), {})

        rec["trace"] = devtrace.traced(one, mix["profile_rooms"], dev)
        if dev.type == "cuda":
            rec["memory_peak_bytes"] = max(
                rec["memory_peak_bytes"], torch.cuda.max_memory_allocated(dev))
    del model, predict
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    mean = {k: np.mean([r["events"][k] for r in requests] or [0])
            for k in ("crop_s", "forward_s", "scatter_s", "chunks")}
    log(f"# set-up {setup_s:.2f} s, window {rec['window_s']:.2f} s, "
        f"{len(requests)} rooms, median latency "
        f"{np.median([r['latency_s'] for r in requests] or [0]):.3f} s; a "
        f"room: crop / forward / scatter {1e3 * mean['crop_s']:.0f} / "
        f"{1e3 * mean['forward_s']:.0f} / {1e3 * mean['scatter_s']:.0f} ms, "
        f"{mean['chunks']:.1f} chunks")
    if trace:
        t = time.perf_counter()
        rec["work"] = _work(cfg, mix, scenes, seed,
                            [r["index"] for r in requests], traced, dev)
        log(f"# work count {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    rec["checks"] = check.judge(
        _compare(cfg, mix, scenes, seed, w, votes, requests, dev), limits)
    log(f"# reference {time.perf_counter() - t:.2f} s")
    return rec


def _compare(cfg, mix, scenes, seed, w, votes, requests, dev,
             rnd=None) -> dict:
    """The widest gaps of the checked rooms' votes, every point, from the
    reference's votes over the same chunks (``rnd``: the precision
    control's rounding, compared with the reference itself)."""
    worst: dict = {}
    with ref_models.float32_exact():
        for idx in sample(requests, seed, mix["check_rooms"]):
            xyz, rgb = room_request(cfg, mix, scenes, seed, idx)
            ref = ref_vote.room_votes(w, cfg["radii"], xyz, rgb,
                                      device=dev, **_voting(cfg, mix))
            port = (votes[idx] if rnd is None else ref_vote.room_votes(
                w, cfg["radii"], xyz, rgb, device=dev, rnd=rnd,
                **_voting(cfg, mix)))
            for k, v in check.logit_gaps(port, ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _work(cfg, mix, scenes, seed, window, traced, dev) -> dict:
    """Useful operations of the window's rooms and the conv least seconds
    of the traced rooms, from the harness's own pair counts over every
    chunk the frozen crop cuts (the rows that pad the last batch are not
    counted): the trunk's forward and the 744-wide head over every chunk
    point."""
    widths = [cfg["in_features"], *cfg["channels"]]
    dims = [head_in(cfg), *cfg["head_dims"], cfg["num_classes"]]
    n, bs = cfg["num_points"], cfg["batch_size"]

    def room(idx):
        xyz, rgb = room_request(cfg, mix, scenes, seed, idx)
        blocks = ref_vote.chunks(xyz, rgb, num_points=n,
                                 block_size=cfg["block_size"],
                                 stride=mix["stride"])
        ops = least = 0.0
        for s in range(0, len(blocks["points"]), bs):
            pts = torch.from_numpy(blocks["points"][s:s + bs]).to(dev)
            pairs = work.cloud_pairs(pts, cfg["radii"])
            o, l = work.forward_work(pairs, len(pts) * n, widths)
            ops += o + work.head_ops(len(pts) * n, dims, 1)
            least += l
        return ops, least

    return dict(window_ops=sum(room(i)[0] for i in window),
                traced_conv_least_s=sum(room(i)[1] for i in traced))


@contextlib.contextmanager
def vote_moved():
    """The voting path's votes of one point replaced by another point's."""
    from pointwise_torch.data import s3dis

    real = s3dis.predict_scene_voting

    def moved(*a, **k):
        out = real(*a, **k)
        out["votes"][0] = out["votes"][len(out["votes"]) // 2]
        return out

    s3dis.predict_scene_voting = moved
    try:
        yield
    finally:
        s3dis.predict_scene_voting = real


@contextlib.contextmanager
def chunk_left_out():
    """The first chunk of every room left out of its votes (its logits
    zeroed where the voting path receives them)."""
    from pointwise_torch.data import s3dis

    real = s3dis.predict_scene_voting

    def left_out(predict_logits, *a, **k):
        calls = []

        def first_dropped(points, features, mask):
            out = np.array(predict_logits(points, features, mask))
            if not calls:
                out[0] = 0.0
            calls.append(len(out))
            return out

        return real(first_dropped, *a, **k)

    s3dis.predict_scene_voting = left_out
    try:
        yield
    finally:
        s3dis.predict_scene_voting = real


def control_readings(workload: str, seed: int, device="cuda") -> dict:
    """The compared numbers of the precision control (the reference with
    its convs' inputs in fp8) against the reference, on the first
    ``check_rooms`` rooms of a run of ``workload`` with ``seed``."""
    bench = cell.load_benchmark()
    c, centry = cell.find(bench, workload)
    cfg = cell.load_json(cell.ROOT, centry["file"])
    mix = traffic.load(c["traffic"])
    dev = torch.device(device)
    w = weights.make(cfg, cfg["in_features"], head_in(cfg),
                     traffic.sub_seed(seed, 1), dev)
    scenes = traffic.base_scenes(cfg, mix, seed)
    requests = [dict(index=i, points=1) for i in range(mix["check_rooms"])]
    return _compare(cfg, mix, scenes, seed, w, None, requests, dev,
                    rnd=round_fp8)
