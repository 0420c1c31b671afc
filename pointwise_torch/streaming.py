"""Exact streaming inference for scans too large for one padded batch.

A port of pointwise_tpu/streaming.py (single device).  The engine is exact
overlap-save convolution:

  * the scene is partitioned into spatial tiles (native grid-hash index,
    pointwise_torch/native);
  * each tile is processed together with a halo of width H = sum of the
    network's kernel radii (the receptive field of the conv stack), so the
    tile-interior outputs equal the full-scene computation exactly;
  * tiles are padded to a small set of bucket sizes and batched per bucket;
  * tile coordinates are re-centered before entering the net — the conv is
    translation-invariant, and this keeps f32 precision over large scenes.

Memory high-water on the device is one bucket batch plus the resident scene,
independent of the number of tiles.
"""

from __future__ import annotations

import collections
import concurrent.futures
import queue as queue_mod
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from pointwise_torch import resolve_device
from pointwise_torch.kernels.pointwise_conv_cuda import SENTINEL
from pointwise_torch.native import GridIndex, morton_codes
from pointwise_torch.utils.spatial import morton_code

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


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def stream_apply(
    apply_fn: Callable,
    xyz: np.ndarray,
    features: np.ndarray,
    *,
    halo: float,
    tile_size: float,
    out_dim: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    tile_batch: int = 4,
    progress: Callable | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Run ``apply_fn(points, features, mask) -> (B, N, out_dim)`` over a
    whole scene, tile by tile, exactly (the arguments arrive as tensors on
    ``device``).

    apply_fn must be translation-invariant in ``points`` (pointwise-conv
    stacks are) and respect ``mask``.  ``halo`` must be >= the receptive
    field (sum of kernel radii) for exactness.

    Returns (len(xyz), out_dim) float32 outputs for every point.
    """
    dev = resolve_device(device)
    xyz = np.asarray(xyz, np.float32)
    features = np.asarray(features, np.float32)
    grid = GridIndex(xyz, tile_size)

    jobs = []
    for c in grid.nonempty_cells():
        # interiors come from the index's EXACT cell partition — a float
        # AABB re-query can disagree by 1 ulp at cell seams
        interior = grid.cell_points(c)
        if len(interior) == 0:
            continue
        lo = grid.origin + c.astype(np.float32) * tile_size
        hi = lo + tile_size
        cand = grid.query_box(lo - halo, hi + halo + 1e-5)
        # morton order keeps the kernel's tiles spatially compact
        cand = cand[np.argsort(morton_code(xyz[cand]), kind="stable")]
        jobs.append((lo + 0.5 * tile_size, interior, cand))

    groups: dict[int, list] = {}
    for job in jobs:
        groups.setdefault(_bucket_for(len(job[2]), buckets), []).append(job)

    out = np.zeros((len(xyz), out_dim), np.float32)
    done = 0
    for b in sorted(groups):
        js = groups[b]
        tbs = max(1, min(tile_batch, (8192 * tile_batch) // b))
        for s in range(0, len(js), tbs):
            chunk = js[s : s + tbs]
            pts = np.full((tbs, b, 3), SENTINEL, np.float32)
            fts = np.zeros((tbs, b, features.shape[-1]), np.float32)
            msk = np.zeros((tbs, b), np.float32)
            for t, (center, _, cand) in enumerate(chunk):
                k = len(cand)
                pts[t, :k] = xyz[cand] - center     # translation-invariant
                fts[t, :k] = features[cand]
                msk[t, :k] = 1.0
            logits = apply_fn(*(torch.from_numpy(a).to(dev)
                                for a in (pts, fts, msk)))
            logits = logits.float().cpu().numpy()
            for t, (center, interior, cand) in enumerate(chunk):
                order = np.argsort(cand)
                pos = order[np.searchsorted(cand[order], interior)]
                out[interior] = logits[t, pos]
            done += len(chunk)
            if progress:
                progress(done, len(jobs), b)
    return out


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
    device: str | torch.device = "cuda",
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
    (presort_s, build_s, pack_s, wait_packer_s, dispatch_s, flush_fetch_s,
    flush_scatter_s, total_s) and n_jobs.

    ``mesh`` / ``scene_axis`` (multi-device) are not yet ported.
    """
    if mesh is not None or scene_axis is not None:
        raise NotImplementedError(
            "stream_apply_layered mesh/scene_axis: not yet ported")
    dev = resolve_device(device)
    ev_t = collections.defaultdict(float)
    t_start = time.perf_counter()

    xyz_in = np.asarray(xyz, np.float32)
    features_in = np.asarray(features, np.float32)
    # GLOBAL morton pre-sort, once: every per-tile candidate set is then a
    # sorted-index array already in morton order.  Outputs are written back
    # through ``order``.
    order = np.argsort(morton_codes(xyz_in), kind="stable")
    xyz = np.ascontiguousarray(xyz_in[order])
    features = np.ascontiguousarray(features_in[order])
    radii = [float(r) for r in radii]
    # halos[l] = receptive field remaining BEFORE layer l
    halos = [sum(radii[l:]) for l in range(len(radii))]
    L = len(radii)
    ev_t["presort_s"] = time.perf_counter() - t_start
    grid = GridIndex(xyz, tile_size)

    def build_job(c):
        lo = grid.origin + c.astype(np.float32) * tile_size
        hi = lo + tile_size
        job = _nested_candidates(grid, c, lo, hi, halos)
        if job is None:
            return None
        return (lo + 0.5 * tile_size, *job)

    # schedule building is pure host work (native box queries + sorts, all
    # GIL-releasing) — build every tile's schedule in parallel
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        jobs = [j for j in ex.map(build_job, grid.nonempty_cells())
                if j is not None]
    ev_t["build_s"] = time.perf_counter() - t0

    ladder = tuple(sorted({128, 256} | set(buckets)))

    def pad_len(n):
        # fine-grained above the ladder top: power-of-2 jumps waste up to 2x
        # padded compute on big tiles; 8K-multiples bound the waste to <6%.
        if n <= ladder[-1]:
            return _bucket_for(n, ladder)
        return int(-(-n // 8192) * 8192)

    # Grouping: the per-group schedule is the elementwise MAX over members,
    # so a tile that runs one per chunk anyway (tbs == 1 at its bucket) gets
    # its OWN padded schedule (tuple key) instead of padding up to the
    # bucket's maxima; small tiles keep the bucket key (int) so chunks stay
    # full.
    groups: dict = {}
    for job in jobs:
        counts = job[3]
        b = _bucket_for(int(counts[0]), buckets)
        forced_single = (8192 * tile_batch) // b <= 1
        key = tuple(pad_len(int(c)) for c in counts) if forced_single else b
        groups.setdefault(key, []).append(job)
    _coalesce(groups)

    scene_xyz = torch.from_numpy(xyz).to(dev)
    scene_fts = torch.from_numpy(features).to(dev)

    meta = {}
    for b in sorted(groups, key=_gorder):
        p0 = b if isinstance(b, int) else b[0]
        tbs = max(1, min(tile_batch, (8192 * tile_batch) // p0))
        if isinstance(b, int):
            gmax = np.max(np.stack([j[3] for j in groups[b]]), axis=0)
            lengths = tuple(pad_len(int(m)) for m in gmax)
        else:
            lengths = b       # per-schedule group: the key IS the schedule
        if length_profiles is not None:
            # A profile entry that elementwise covers this scene is reused
            # (extra slots are sentinel-dead -> still exact); on a miss the
            # entry is merged UP.  A stale entry from another config (other
            # radii -> other schedule length, other tbs) is replaced.
            prof = length_profiles.get(b)
            covered_elsewhere = False
            if (prof is not None and prof[0] == tbs
                    and len(prof[1]) == len(lengths)):
                lengths = tuple(max(int(p), l)
                                for p, l in zip(prof[1], lengths))
            elif prof is None and not isinstance(b, int):
                # tuple-keyed groups: reuse the cheapest existing entry that
                # elementwise covers this schedule
                best = None
                for k2, (t2, l2) in length_profiles.items():
                    if (not isinstance(k2, int) and t2 == tbs
                            and len(l2) == len(lengths)
                            and all(a >= c for a, c in zip(l2, lengths))):
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

    def pack_chunks(q):
        """Producer thread: pad + pack every chunk's host arrays off the
        dispatch path.  The bounded queue keeps a few chunks ahead."""
        try:
            for b in sorted(groups, key=_gorder):
                js = groups[b]
                tbs, lengths = meta[b]
                p0, p_last = lengths[0], lengths[-1]
                for s in range(0, len(js), tbs):
                    t0 = time.perf_counter()
                    chunk = js[s : s + tbs]
                    cand_h = np.zeros((tbs, p0), np.int32)
                    ctr_h = np.zeros((tbs, 3), np.float32)
                    cnt = np.zeros((tbs, L + 1), np.int32)
                    sels = [np.zeros((tbs, lengths[l + 1]), np.int32)
                            for l in range(L)]
                    skips = [np.zeros((tbs, p_last), np.int32)
                             for l in range(L)]
                    for t, (center, _, cand, counts, sel, skip) in enumerate(
                            chunk):
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

    out = np.zeros((len(xyz), out_dim), np.float32)
    done = 0
    pending: collections.deque = collections.deque()

    def flush():
        nonlocal done
        t0 = time.perf_counter()
        logits_d, interiors, b = pending.popleft()
        logits = logits_d.float().cpu().numpy()     # device->host barrier
        ev_t["flush_fetch_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for t, interior_ids in enumerate(interiors):
            # interior ids live in SORTED index space; map back through the
            # morton pre-sort permutation into the caller's point order
            out[order[interior_ids]] = logits[t, : len(interior_ids)]
        ev_t["flush_scatter_s"] += time.perf_counter() - t0
        done += len(interiors)
        if progress:
            progress(done, len(jobs), b)

    def put(a):
        return torch.from_numpy(a).to(dev)

    q: queue_mod.Queue = queue_mod.Queue(maxsize=3)
    packer = threading.Thread(target=pack_chunks, args=(q,), daemon=True)
    packer.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            ev_t["wait_packer_s"] += time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            b, lengths, cand_h, ctr_h, cnt, sels, skips, interiors = item
            t0 = time.perf_counter()
            pts_d, fts_d = _stage(scene_xyz, scene_fts, put(cand_h),
                                  put(ctr_h), put(cnt[:, 0]))
            logits_d = apply_fn(pts_d, fts_d, put(cnt),
                                tuple(put(x) for x in sels),
                                tuple(put(x) for x in skips), lengths)
            ev_t["dispatch_s"] += time.perf_counter() - t0
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
    return out
