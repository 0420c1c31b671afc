"""Exact streaming inference for scans too large for one padded batch.

A port of pointwise_tpu/streaming.py; under a parallel.mesh.Mesh the tile
batches shard over its data axis and the resident scene's rows over its
space axis (stream_apply_layered).  The engine is exact overlap-save
convolution:

  * the scene is partitioned into spatial tiles (native grid-hash index,
    pointwise_torch/native);
  * each tile is processed together with a halo of width H = sum of the
    network's kernel radii (the receptive field of the conv stack), so the
    tile-interior outputs equal the full-scene computation exactly; the
    halo shrinks layer by layer to the receptive field that remains;
  * tiles are padded to a small set of bucket sizes and batched per bucket;
  * tile coordinates are re-centered before entering the net — the conv is
    translation-invariant, and this keeps f32 precision over large scenes.

Memory high-water on the device is one bucket batch plus the resident scene,
independent of the number of tiles.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import queue as queue_mod
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pointwise_torch import native, resolve_device
from pointwise_torch.kernels.pointwise_conv_cuda import (HOST_SYNCS,
                                                        SENTINEL, count_sync)
from pointwise_torch.native import GridIndex
from pointwise_torch.parallel.mesh import all_gather_cat, all_reduce
from pointwise_torch.utils.runtime import span

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def _stage(sx, sf, cand, centers, n0):
    """On-device tile staging: gather candidate rows from the resident
    scene, re-center (translation invariance), sentinel-pad dead slots."""
    live = (torch.arange(cand.shape[1], device=cand.device)[None, :]
            < n0[:, None])
    pts = torch.where(live[..., None], sx[cand] - centers[:, None, :],
                      SENTINEL)
    fts = torch.where(live[..., None], sf[cand], 0.0)
    return pts, fts


def _resident_scene(xyz, features, dev, mesh, scene_axis):
    """The morton-sorted scene's rows that live on this rank's device:
    (xyz, features, index of the first row).  With ``scene_axis`` the scene
    is padded with sentinel rows (zero features; no candidate index points
    there) to a multiple of the axis size, and the rank at index s keeps
    rows [s*L, (s+1)*L); otherwise it keeps every row."""
    lo, hi = 0, len(xyz)
    if scene_axis is not None:
        n = dist.get_world_size(mesh.group(scene_axis))
        rows = -(-len(xyz) // n)
        pad = rows * n - len(xyz)
        xyz = np.concatenate([xyz, np.full((pad, 3), SENTINEL, np.float32)])
        features = np.concatenate(
            [features, np.zeros((pad, features.shape[1]), np.float32)])
        lo = mesh.index(scene_axis) * rows
        hi = lo + rows
    return (_upload(xyz[lo:hi], dev, "engine_resident"),
            _upload(features[lo:hi], dev, "engine_resident"), lo)


def _upload(a, dev, site):
    """Numpy array ``a`` as a tensor on ``dev``: a copy from pageable
    memory, which blocks the host (one ``HOST_SYNCS[site]``)."""
    count_sync(site)
    return torch.from_numpy(a).to(dev)


def _stage_owned(first, group, sx, sf, cand, centers, n0):
    """``_stage`` over a row-sharded scene (the owner-gather): each member
    of ``group`` gathers the candidate rows it holds (``sx``/``sf`` are
    global rows ``first ..``) and zeros elsewhere, and one SUM all-reduce
    over the group assembles the tile.  Every index has exactly one owner,
    so each staged value is its owner's value plus zeros: the same bits as
    ``_stage`` on the whole scene, a negative zero aside (-0.0 + 0.0 is
    +0.0)."""
    sel = cand.long() - first
    owned = ((sel >= 0) & (sel < sx.shape[0]))[..., None]
    sel = sel.clamp(0, sx.shape[0] - 1)
    rows = all_reduce(torch.where(owned, torch.cat([sx[sel], sf[sel]], -1),
                                  0.0), group)
    live = (torch.arange(cand.shape[1], device=cand.device)[None, :]
            < n0[:, None])[..., None]
    pts = torch.where(live, rows[..., :3] - centers[:, None, :], SENTINEL)
    fts = torch.where(live, rows[..., 3:], 0.0)
    return pts, fts


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def _nested_candidates(grid, cell, lo, hi, halos):
    """One tile's candidate set plus the nested-prefix gather schedule.

    REQUIRES the scene to be GLOBALLY morton-sorted (stream_apply_layered
    pre-sorts once): every query_box result, sorted ascending by index, is
    then in morton order.  The candidate array stays morton-ordered as a
    whole (the kernel's tile walk needs spatially compact tiles); the
    per-depth shrinkage is expressed as index gathers: chain[l] = positions
    (within S_0) of S_{l+1} = tile + halo_{l+1}; sels[l] re-indexes S_{l+1}
    within S_l.

    Returns (interior ids in output order, cand ids, counts[L+1],
    sels[L], skips[L]) or None for an empty tile.
    """
    interior = np.sort(grid.cell_points(cell))
    if len(interior) == 0:
        return None
    sets = [np.sort(grid.query_box(lo - h, hi + h + 1e-5))
            for h in halos]                                    # S_0..S_{L-1}
    s0 = sets[0]
    chain = [np.searchsorted(s0, s).astype(np.int64) for s in sets[1:]]
    chain.append(np.searchsorted(s0, interior).astype(np.int64))
    counts = np.asarray([len(s0)] + [len(c) for c in chain], np.int32)
    sels = []
    cur = np.arange(len(s0), dtype=np.int64)
    for nxt in chain:  # S_{l+1} positions within S_l (both sorted)
        sels.append(np.searchsorted(cur, nxt).astype(np.int32))
        cur = nxt
    skips = [np.searchsorted(chain[l], chain[-1]).astype(np.int32)
             for l in range(len(chain))]
    return s0[chain[-1]], s0, counts, sels, skips


def _sched_cost(ls):
    """Padded pair cost of a schedule: sum of p_l * p_{l+1}."""
    return sum(a * c for a, c in zip(ls, ls[1:]))


def _coalesce(groups: dict) -> None:
    """Merge near-identical big-tile (tuple-keyed) schedules in place.

    Greedy, costliest first: a schedule folds into a kept one whenever the
    elementwise max costs at most 10% more than it (exact either way: the
    extra slots are sentinel-dead); this bounds the number of distinct
    schedules, and so the shapes the device sees, at a bounded compute
    premium.  A key that an earlier merge already produced (the max of two
    schedules can equal a key visited later) is kept as it is: its members
    are already in its group, and popping it again would raise KeyError.
    """
    tkeys = sorted((k for k in groups if not isinstance(k, int)),
                   key=_sched_cost, reverse=True)
    kept: list = []
    for k in tkeys:
        if k in kept:
            continue
        for i, kk in enumerate(kept):
            m = tuple(max(a, c) for a, c in zip(kk, k))
            if _sched_cost(m) <= 1.10 * _sched_cost(k):
                members = groups.pop(k) + groups.pop(kk)
                if m in groups:                   # rare 3-way union
                    groups[m].extend(members)
                else:
                    groups[m] = members
                kept[i] = m
                kept = list(dict.fromkeys(kept))
                break
        else:
            kept.append(k)


def _gorder(k):
    return (k,) if isinstance(k, int) else k


def stream_apply_layered(
    apply_fn: Callable,
    xyz: np.ndarray,
    features: np.ndarray,
    *,
    radii: Sequence[float],
    tile_size: float,
    out_dim: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    tile_batch: int = 4,
    progress: Callable | None = None,
    length_profiles: dict | None = None,
    events: dict | None = None,
    device: str | torch.device | None = None,
    mesh=None,
    scene_axis: str | None = None,
) -> np.ndarray:
    """Exact streaming with LAYER-WISE SHRINKING HALOS.

    Layer ``l``'s outputs are only needed within the REMAINING receptive
    field halo_l = sum(radii[l:]), so the candidate walk shrinks with depth.
    Each layer's needed set is an on-device index gather of the previous
    one (global morton order preserved — see _nested_candidates), and
    ``apply_fn(points, features, counts, sels, skips, lengths) ->
    (B, p_L, out_dim)`` (e.g. PointwiseSegmenter.streaming_logits) gets the
    tile batch as tensors on ``device``.

    The scene's xyz/features are uploaded ONCE; per tile the host sends only
    int32 index/schedule arrays and ``_stage`` gathers + recenters on the
    device.  A packer thread builds the host arrays ahead of the dispatch
    loop, and each chunk's logits are fetched one chunk later, so host
    packing, device work and the device->host copy overlap.

    ``lengths`` is a padded tuple per bucket group from a small ladder, so
    the device sees a bounded set of shapes.  ``length_profiles``: optional
    mutable dict {bucket: (tbs, lengths)} shared across calls (keep-alive
    serving): schedules are reused when an existing entry covers the new
    scene and merged up otherwise.

    ``events``: optional dict the engine fills with phase wall-times
    (presort_s, grid_s, build_s, plan_s, pack_s, wait_packer_s, dispatch_s,
    flush_fetch_s, flush_scatter_s, total_s), n_jobs, schedule_native (the
    tiles whose schedule the native pass built: n_jobs with the native
    library, 0 on its NumPy fallback), resident_bytes (the bytes of the
    scene this rank holds on its device) and host_syncs (the calls of this
    one that blocked the host on the device, ``HOST_SYNCS``'s increase).
    Each phase of the calling thread is a ``runtime.span`` (engine.presort,
    engine.grid, engine.build, engine.plan, engine.wait_packer,
    engine.dispatch, engine.fetch, engine.scatter), so a profiler's trace
    shows it; the packer thread's pack_s is timed only, since a range there
    would claim the calling thread's idle time.

    ``device``: where the tiles run (default the card); under a mesh, the
    mesh's device.

    ``mesh`` (a parallel.mesh.Mesh; every rank of it calls this with the
    same scene and arguments): each chunk of ``tbs`` tiles, ``tbs`` rounded
    up to a multiple of the mesh's data size n, is split over its "data"
    axis; the rank at data index d stages and applies rows
    [d*tbs/n, (d+1)*tbs/n) and the logits come back over the "data" group,
    so every rank returns the whole output.  Every rank builds the same
    schedule from the same scene.  ``scene_axis`` (requires ``mesh``) also
    row-shards the resident
    scene over that axis, the only O(N_scene) device allocation (36 B per
    point at 6 features): each rank keeps its block of the morton-sorted
    scene and staging is the owner-gather of ``_stage_owned``; members of
    one scene-axis group compute the same rows.  Every collective runs on
    this (the dispatch) thread in chunk order, never on the packer's.
    """
    if scene_axis is not None and mesh is None:
        raise ValueError("scene_axis requires a mesh")
    if mesh is None:
        dev = resolve_device(device)
        n_data, d_index = 1, 0
    else:
        dev = mesh.device
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device {device} but the mesh runs on {dev}")
        n_data, d_index = mesh.data, mesh.index("data")
    ev_t = collections.defaultdict(float)
    t_start = time.perf_counter()
    syncs0 = sum(HOST_SYNCS.values())

    with span("engine.presort", ev_t, "presort_s"):
        # GLOBAL morton pre-sort, once: every per-tile candidate set is then
        # a sorted-index array already in morton order.  Outputs are written
        # back through ``order``.
        order, xyz, features, lo_all, hi_all = native.presort(xyz, features)
        radii = [float(r) for r in radii]
        # halos[l] = receptive field remaining BEFORE layer l
        halos = [sum(radii[l:]) for l in range(len(radii))]
        L = len(radii)
    with span("engine.grid", ev_t, "grid_s"):
        grid = GridIndex(xyz, tile_size, bbox=(lo_all, hi_all))

    # one native walk per tile with the library (GridIndex.nested_schedule,
    # each build thread with depth bytes of its own), else the NumPy
    # reference; the same arrays either way
    schedule_native = native.available()
    per_thread = threading.local()

    def build_job(c):
        lo = grid.origin + c.astype(np.float32) * tile_size
        hi = lo + tile_size
        if schedule_native:
            if not hasattr(per_thread, "depth"):
                per_thread.depth = np.zeros(len(xyz), np.uint8)
            job = grid.nested_schedule(
                c, [lo - h for h in halos], [hi + h + 1e-5 for h in halos],
                per_thread.depth)
        else:
            job = _nested_candidates(grid, c, lo, hi, halos)
        if job is None:
            return None
        return (lo + 0.5 * tile_size, *job)

    # schedule building is pure host work (native passes, or box queries +
    # sorts, all GIL-releasing) — build every tile's schedule in parallel
    with span("engine.build", ev_t, "build_s"), \
            concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        jobs = [j for j in ex.map(build_job, grid.nonempty_cells())
                if j is not None]
    ev_t["schedule_native"] = len(jobs) if schedule_native else 0

    # grouping, coalescing, the length profiles, the resident scene and
    # the output
    with span("engine.plan", ev_t, "plan_s"):
        ladder = tuple(sorted({128, 256} | set(buckets)))

        def pad_len(n):
            # fine-grained above the ladder top: power-of-2 jumps waste up
            # to 2x padded compute on big tiles; 8K-multiples bound the
            # waste to <6%.
            if n <= ladder[-1]:
                return _bucket_for(n, ladder)
            return int(-(-n // 8192) * 8192)

        # Grouping: the per-group schedule is the elementwise MAX over
        # members, so a tile that runs one per chunk anyway (tbs == 1 at its
        # bucket) gets its OWN padded schedule (tuple key) instead of padding
        # up to the bucket's maxima; small tiles keep the bucket key (int) so
        # chunks stay full.  Not under a data axis of more than one rank: it
        # rounds every chunk up to n_data tiles, which would leave
        # per-schedule chunks mostly empty where bucket groups pack them
        # full.
        groups: dict = {}
        for job in jobs:
            counts = job[3]
            b = _bucket_for(int(counts[0]), buckets)
            forced_single = (8192 * tile_batch) // b <= 1
            key = (tuple(pad_len(int(c)) for c in counts)
                   if (forced_single and n_data == 1) else b)
            groups.setdefault(key, []).append(job)
        _coalesce(groups)

        scene_xyz, scene_fts, first = _resident_scene(xyz, features, dev,
                                                      mesh, scene_axis)
        stage = (_stage if scene_axis is None else functools.partial(
            _stage_owned, first, mesh.group(scene_axis)))
        ev_t["resident_bytes"] = sum(t.numel() * t.element_size()
                                     for t in (scene_xyz, scene_fts))

        meta = {}
        for b in sorted(groups, key=_gorder):
            p0 = b if isinstance(b, int) else b[0]
            tbs = max(1, min(tile_batch, (8192 * tile_batch) // p0))
            tbs = -(-tbs // n_data) * n_data   # divisible by the data axis
            if isinstance(b, int):
                gmax = np.max(np.stack([j[3] for j in groups[b]]), axis=0)
                lengths = tuple(pad_len(int(m)) for m in gmax)
            else:
                lengths = b   # per-schedule group: the key IS the schedule
            if length_profiles is not None:
                # A profile entry that elementwise covers this scene is
                # reused (extra slots are sentinel-dead -> still exact); on a
                # miss the entry is merged UP.  A stale entry from another
                # config (other radii -> other schedule length, other tbs) is
                # replaced.
                prof = length_profiles.get(b)
                covered_elsewhere = False
                if (prof is not None and prof[0] == tbs
                        and len(prof[1]) == len(lengths)):
                    lengths = tuple(max(int(p), l)
                                    for p, l in zip(prof[1], lengths))
                elif prof is None and not isinstance(b, int):
                    # tuple-keyed groups: reuse the cheapest existing entry
                    # that elementwise covers this schedule
                    best = None
                    for k2, (t2, l2) in length_profiles.items():
                        if (not isinstance(k2, int) and t2 == tbs
                                and len(l2) == len(lengths)
                                and all(a >= c
                                        for a, c in zip(l2, lengths))):
                            cost = _sched_cost(l2)
                            if best is None or cost < best[0]:
                                best = (cost, tuple(int(x) for x in l2))
                    if best is not None:
                        lengths = best[1]
                        covered_elsewhere = True
                # a schedule served by ANOTHER key's covering entry is not
                # re-inserted under its own key, so the profile stays bounded
                if not covered_elsewhere:
                    length_profiles[b] = (tbs, lengths)
            meta[b] = (tbs, lengths)

        out = np.zeros((len(xyz), out_dim), np.float32)
        done = 0
        pending: collections.deque = collections.deque()

    def pack_chunks(q):
        """Producer thread: pad + pack every chunk's host arrays off the
        dispatch path.  The bounded queue keeps a few chunks ahead."""
        try:
            for b in sorted(groups, key=_gorder):
                js = groups[b]
                tbs, lengths = meta[b]
                p0, p_last = lengths[0], lengths[-1]
                rows = tbs // n_data          # this rank's rows of a chunk
                for s in range(0, len(js), tbs):
                    t0 = time.perf_counter()
                    chunk = js[s : s + tbs]
                    mine = chunk[d_index * rows:(d_index + 1) * rows]
                    cand_h = np.zeros((rows, p0), np.int32)
                    ctr_h = np.zeros((rows, 3), np.float32)
                    cnt = np.zeros((rows, L + 1), np.int32)
                    sels = [np.zeros((rows, lengths[l + 1]), np.int32)
                            for l in range(L)]
                    skips = [np.zeros((rows, p_last), np.int32)
                             for l in range(L)]
                    for t, (center, _, cand, counts, sel, skip) in enumerate(
                            mine):
                        cand_h[t, : len(cand)] = cand
                        ctr_h[t] = center           # translation-invariant
                        cnt[t] = counts
                        for l in range(L):
                            sels[l][t, : len(sel[l])] = sel[l]
                            skips[l][t, : len(skip[l])] = skip[l]
                    interiors = [c[1] for c in chunk]
                    ev_t["pack_s"] += time.perf_counter() - t0
                    q.put((b, lengths, cand_h, ctr_h, cnt, sels, skips,
                           interiors))
        except BaseException as e:   # surface packer failures in the caller
            q.put(e)
        else:
            q.put(None)

    def flush():
        nonlocal done
        with span("engine.fetch", ev_t, "flush_fetch_s"):
            logits_d, interiors, b = pending.popleft()
            if n_data > 1:          # every rank's rows, in data-index order
                logits_d = all_gather_cat(logits_d, mesh.group("data"), 0)
            count_sync("engine_fetch")
            logits = logits_d.float().cpu().numpy()  # device->host barrier
        with span("engine.scatter", ev_t, "flush_scatter_s"):
            for t, interior_ids in enumerate(interiors):
                # interior ids live in SORTED index space; map back through
                # the morton pre-sort permutation into the caller's order
                out[order[interior_ids]] = logits[t, : len(interior_ids)]
        done += len(interiors)
        if progress:
            progress(done, len(jobs), b)

    def put(a):
        return _upload(a, dev, "engine_put")

    q: queue_mod.Queue = queue_mod.Queue(maxsize=3)
    packer = threading.Thread(target=pack_chunks, args=(q,), daemon=True)
    packer.start()
    try:
        while True:
            with span("engine.wait_packer", ev_t, "wait_packer_s"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            b, lengths, cand_h, ctr_h, cnt, sels, skips, interiors = item
            with span("engine.dispatch", ev_t, "dispatch_s"):
                pts_d, fts_d = stage(scene_xyz, scene_fts, put(cand_h),
                                     put(ctr_h), put(cnt[:, 0]))
                logits_d = apply_fn(pts_d, fts_d, put(cnt),
                                    tuple(put(x) for x in sels),
                                    tuple(put(x) for x in skips), lengths)
            pending.append((logits_d, interiors, b))
            if len(pending) >= 2:
                flush()
    except BaseException:
        # Run the packer down before propagating: a keep-alive server
        # catches per-request errors, and a packer blocked on the bounded
        # queue would otherwise leak a thread and its queued chunks.
        while packer.is_alive():
            try:
                q.get_nowait()
            except queue_mod.Empty:
                packer.join(timeout=0.05)
        raise
    packer.join()
    while pending:
        flush()
    ev_t["total_s"] = time.perf_counter() - t_start
    ev_t["n_jobs"] = len(jobs)
    if events is not None:
        events.update({k: round(float(v), 4) for k, v in ev_t.items()})
        events["host_syncs"] = sum(HOST_SYNCS.values()) - syncs0
    return out
