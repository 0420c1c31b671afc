"""The serving loop: a closed loop of one client handing scans to the
program's exact streaming engine, one at a time.

Entry driven: ``pointwise_torch.streaming.stream_apply_layered`` over
``infer.layered_apply(infer.build_model(...))``, as ``infer.serve`` calls
it, with one ``length_profiles`` dict kept across the run's requests.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, devtrace, traffic, weights, work
from benchmark.cell import port_config
from benchmark.reference import models as ref_models


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, limits: dict, log) -> dict:
    """One run; returns the record the metric readers read."""
    from pointwise_torch import infer, streaming
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels

    dev = torch.device(device)
    pcfg = port_config(cfg)
    model = infer.build_model(pcfg, dev, precision=cfg["precision"])
    w = weights.make(cfg, cfg["in_features"], sum(cfg["channels"]),
                     traffic.sub_seed(seed, 1), dev)
    model.load_state_dict(w, strict=True)
    apply = infer.layered_apply(model)
    scenes = traffic.base_scenes(cfg, mix, seed)
    profiles: dict = {}

    def serve(xyz, feats, events):
        with record_function("harness.stream_apply_layered"):
            return streaming.stream_apply_layered(
                apply, xyz, feats, radii=cfg["radii"],
                tile_size=mix["tile_size"], out_dim=cfg["num_classes"],
                tile_batch=mix["tile_batch"], length_profiles=profiles,
                events=events, device=dev)

    for i in range(mix["warm_scans"]):
        serve(*traffic.scan_request(cfg, mix, scenes, seed, i, warm=True),
              {})
    devtrace.sync(dev)
    setup_s = time.perf_counter() - t_start

    kernels.reset_launches()
    outputs, requests, failed = {}, [], 0
    t0 = time.perf_counter()
    i = 0
    while True:
        xyz, feats = traffic.scan_request(cfg, mix, scenes, seed, i)
        ev = {}
        ts = time.perf_counter()
        try:
            outputs[i] = serve(xyz, feats, ev)
            te = time.perf_counter()
            requests.append(dict(index=i, latency_s=te - ts,
                                 points=len(xyz), events=ev))
        except Exception as e:  # a failed request counts, the loop goes on
            te = time.perf_counter()
            failed += 1
            log(f"request {i} failed: {e!r}"[:400])
        i += 1
        if te - t0 >= seconds and (len(requests) >= mix["check_scans"]
                                   or failed):
            break
    rec = dict(kind="serve", setup_s=setup_s, window_s=te - t0,
               requests=requests, attempted=i, failed=failed,
               launches=dict(kernels.LAUNCHES))
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)

    if trace:
        first = i
        traced_scenes = []

        def one(k):
            idx = first + k
            traced_scenes.append(idx % len(scenes))
            serve(*traffic.scan_request(cfg, mix, scenes, seed, idx), {})

        rec["trace"] = devtrace.traced(one, mix["profile_scans"], dev)
        if dev.type == "cuda":
            rec["memory_peak_bytes"] = max(
                rec["memory_peak_bytes"], torch.cuda.max_memory_allocated(dev))
    del model, apply, profiles
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    lat = [r["latency_s"] for r in requests]
    half = len(lat) // 2
    log(f"# set-up {setup_s:.2f} s, window {rec['window_s']:.2f} s, "
        f"{len(requests)} scans, median latency of the first and second "
        f"half {np.median(lat[:half] or lat):.4f} / "
        f"{np.median(lat[half:]):.4f} s")
    if trace:
        t = time.perf_counter()
        rec["work"] = _work(cfg, scenes, requests, traced_scenes, dev)
        log(f"# work count {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    rec["checks"] = check.judge(
        _compare(cfg, mix, scenes, seed, w, outputs, requests, dev), limits)
    log(f"# reference {time.perf_counter() - t:.2f} s")
    return rec


def sample(requests: list, seed: int, n: int) -> list:
    """Indices of ``n`` finished requests to check, drawn from the seed,
    the longest among them."""
    rank = np.random.default_rng([int(seed), 9]).permutation(
        len(requests))
    order = sorted(range(len(requests)),
                   key=lambda j: (-requests[j]["points"], rank[j]))
    return [requests[j]["index"] for j in order[:n]]


def _compare(cfg, mix, scenes, seed, w, outputs, requests, dev) -> dict:
    """The widest gaps of the checked scans' logits from the reference's
    direct forward over the whole scene."""
    worst: dict = {}
    with ref_models.float32_exact():
        for idx in sample(requests, seed, mix["check_scans"]):
            xyz, feats = traffic.scan_request(cfg, mix, scenes, seed, idx)
            ref = ref_models.segmenter_scene_logits(
                w, cfg["radii"], torch.from_numpy(xyz).to(dev),
                torch.from_numpy(feats).to(dev))
            for k, v in check.logit_gaps(outputs[idx], ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _work(cfg, scenes, requests, traced_scenes, dev) -> dict:
    """Useful operations of the window's scans and the conv least seconds
    of the traced scans, from the harness's own pair counts (a rigid
    motion keeps them, so each base scene is counted once)."""
    widths = [cfg["in_features"], *cfg["channels"]]
    head = [sum(cfg["channels"]), *cfg["head_dims"], cfg["num_classes"]]
    per_scene = []
    for xyz, _ in scenes:
        x = torch.from_numpy(xyz).to(dev)
        pairs = [work.scene_pairs(x, r) for r in cfg["radii"]]
        ops, least = work.forward_work(pairs, len(xyz), widths)
        per_scene.append((ops + work.head_ops(len(xyz), head, 1), least))
    return dict(
        window_ops=sum(per_scene[r["index"] % len(scenes)][0]
                       for r in requests),
        traced_conv_least_s=sum(per_scene[b][1] for b in traced_scenes))
