"""ctypes bindings for the native grid-hash spatial index (gridhash.cpp).

A copy of ``pointwise_tpu.native`` for the PyTorch package, with two
changes: the shared library is built at first use into ``native/_build/``
(ignored by git), never next to the source; and it also builds the streaming
engine's schedule (``presort``, ``GridIndex.nested_schedule``) and emits the
sliding-block crop's chunks (``crop_chunks``).  Without a
compiler it falls back to a pure NumPy implementation (identical results,
slower): this is host code, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gridhash.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")

_lib = None


def _so_path() -> str:
    # keyed by source content: an edited source never loads a stale library
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libgridhash-{tag}.so")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # temp file + atomic rename: concurrent processes must never CDLL a
        # half-written ELF
        tmp = f"{so}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-pthread", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            pass                      # no compiler: the NumPy path below
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _lib = False
        return _lib
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    lib.gh_build.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_float,
                             i32p, i32p, i32p, i32p]
    lib.gh_build.restype = ctypes.c_int
    lib.gh_query.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_float,
                             i32p, i32p, i32p, f32p, f32p, i32p,
                             ctypes.c_int64]
    lib.gh_query.restype = ctypes.c_int64
    lib.gh_morton.argtypes = [f32p, ctypes.c_int64, f32p, f32p, u32p]
    lib.gh_morton.restype = None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.gh_presort.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int, f32p, f32p, i64p, f32p, f32p]
    lib.gh_presort.restype = None
    lib.gh_sched_mark.argtypes = [f32p, f32p, ctypes.c_float, i32p, i32p,
                                  i32p, ctypes.c_int64, ctypes.c_int32, f32p,
                                  f32p, u8p, i32p, i64p]
    lib.gh_sched_mark.restype = None
    lib.gh_sched_emit.argtypes = [u8p, i64p, ctypes.c_int32, i32p, i32p,
                                  i32p, i32p]
    lib.gh_sched_emit.restype = None
    lib.gh_crop.argtypes = [f32p, f32p, i32p, f32p, f32p, i64p, f32p,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_int, f32p, f32p, i32p, f32p, i32p]
    lib.gh_crop.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return bool(_load())


class GridIndex:
    """Uniform spatial grid over one point set.

    ``bbox``: the points' (min, max) per axis when the caller has them
    already (``presort`` returns them), so that the points are not reduced
    again."""

    def __init__(self, points: np.ndarray, cell_size: float, bbox=None):
        self.points = np.ascontiguousarray(points, np.float32)
        n = len(self.points)
        if bbox is None:
            bbox = self.points.min(axis=0), self.points.max(axis=0)
        self.origin = np.asarray(bbox[0], np.float32)
        extent = np.asarray(bbox[1], np.float32) - self.origin
        self.h = float(cell_size)
        self.dims = np.maximum(
            (extent / self.h).astype(np.int32) + 1, 1
        ).astype(np.int32)
        ncells = int(self.dims[0]) * int(self.dims[1]) * int(self.dims[2])
        if ncells > np.iinfo(np.int32).max:
            # int32 cell ids would wrap negative -> out-of-bounds writes in
            # gh_build (and a silently wrong NumPy fallback)
            raise ValueError(
                f"grid of {ncells} cells exceeds int32 indexing — increase "
                f"cell_size ({self.h}) or shrink the scene extent")
        self.cell_of_point = np.empty(n, np.int32)
        self.cell_starts = np.empty(ncells + 1, np.int32)
        self.order = np.empty(n, np.int32)
        lib = _load()
        if lib:
            lib.gh_build(self.points, n, self.origin, self.h, self.dims,
                         self.cell_of_point, self.cell_starts, self.order)
        else:
            self._build_np()

    def _build_np(self):
        # gh_build's arithmetic: a float32 product with 1/h, not a division
        inv = np.float32(1.0) / np.float32(self.h)
        q = np.clip(
            ((self.points - self.origin) * inv).astype(np.int64),
            0, self.dims.astype(np.int64) - 1,
        )
        c = (q[:, 0] * self.dims[1] + q[:, 1]) * self.dims[2] + q[:, 2]
        self.cell_of_point[:] = c.astype(np.int32)
        ncells = len(self.cell_starts) - 1
        counts = np.bincount(c, minlength=ncells)
        self.cell_starts[0] = 0
        np.cumsum(counts, out=self.cell_starts[1:])
        self.order[:] = np.argsort(c, kind="stable").astype(np.int32)

    def query_box(self, lo, hi) -> np.ndarray:
        """Indices of points with lo <= p < hi."""
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        lib = _load()
        if lib:
            cap = max(1024, len(self.points) // 4)
            while True:
                out = np.empty(cap, np.int32)
                m = lib.gh_query(self.points, len(self.points), self.origin,
                                 self.h, self.dims, self.cell_starts,
                                 self.order, lo, hi, out, cap)
                if m <= cap:
                    return out[:m]
                cap = int(m) + 16
        p = self.points
        m = np.all((p >= lo) & (p < hi), axis=1)
        return np.where(m)[0].astype(np.int32)

    def cell_points(self, coords) -> np.ndarray:
        """Indices of the points in grid cell ``coords`` ((3,) ints).

        This is the EXACT partition the index was built with (every point
        in exactly one cell).  A float AABB re-query of the same cell can
        disagree by 1 ulp at cell seams — a point in the rounding gap
        between two boxes would fall in NEITHER — so tile interiors must
        come from here, not from query_box.
        """
        cid = self._cell_id(coords)
        return self.order[self.cell_starts[cid]:self.cell_starts[cid + 1]]

    def _cell_id(self, coords) -> int:
        return ((int(coords[0]) * int(self.dims[1]) + int(coords[1]))
                * int(self.dims[2]) + int(coords[2]))

    def nested_schedule(self, coords, box_lo, box_hi, depth):
        """``streaming._nested_candidates``' arrays for the tile of grid
        cell ``coords``, in one walk of the cells under the outermost box:
        (interior ids, S_0 ids, counts[L+1] int32, sels[L] int32,
        skips[L] int32).  Box l is [box_lo[l], box_hi[l]) ((L, 3) float32,
        box 0 the outermost, each inside the one before); S_l is the
        points box l holds, in ascending order, and S_L the interior.
        ``depth``: n zero bytes of the calling thread's own, left zero.
        Requires the library (``available()``)."""
        lib = _load()
        box_lo = np.ascontiguousarray(box_lo, np.float32)
        box_hi = np.ascontiguousarray(box_hi, np.float32)
        L = len(box_lo)
        if (box_lo.shape != (L, 3) or box_hi.shape != (L, 3)
                or not 0 < L < 255
                or depth.shape != (len(self.points),)):
            raise ValueError(
                f"boxes {box_lo.shape} / {box_hi.shape} must be (L, 3) with "
                f"0 < L < 255, depth {depth.shape} one byte per point")
        counts = np.empty(L + 1, np.int32)
        span = np.empty(2, np.int64)
        lib.gh_sched_mark(self.points, self.origin, self.h, self.dims,
                          self.cell_starts, self.order,
                          self._cell_id(coords), L, box_lo, box_hi, depth,
                          counts, span)
        s0 = np.empty(counts[0], np.int32)
        sels = np.empty(int(counts[1:].sum()), np.int32)
        skips = np.empty(L * int(counts[L]), np.int32)
        lib.gh_sched_emit(depth, span, L, counts, s0, sels, skips)
        return (self.cell_points(coords), s0, counts,
                np.split(sels, np.cumsum(counts[1:-1])),
                np.split(skips, L))

    def nonempty_cells(self) -> np.ndarray:
        """(k, 3) integer coords of cells containing points."""
        starts = self.cell_starts
        ids = np.where(np.diff(starts) > 0)[0]
        nz = self.dims[2]
        ny = self.dims[1]
        cz = ids % nz
        cy = (ids // nz) % ny
        cx = ids // (nz * ny)
        return np.stack([cx, cy, cz], axis=1).astype(np.int32)


def morton_codes(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, np.float32)
    lib = _load()
    origin = pts.min(axis=0).astype(np.float32)
    span = (pts.max(axis=0) - origin).astype(np.float32)
    if lib:
        out = np.empty(len(pts), np.uint32)
        lib.gh_morton(pts, len(pts), origin, span, out)
        return out
    from pointwise_torch.utils.spatial import morton_code

    return morton_code(pts)


def presort(points: np.ndarray, features: np.ndarray):
    """The streaming engine's global Morton presort of a scene:
    (order, points[order], features[order], lo, hi), where ``order`` is
    ``np.argsort(morton_codes(points), kind="stable")`` (int64), the sorted
    arrays are C-contiguous float32 and (lo, hi) the points' (min, max)
    per axis (float32), for ``GridIndex(..., bbox=(lo, hi))``.  One native
    pass with the library, the NumPy steps without it; the same bits."""
    pts = np.ascontiguousarray(points, np.float32)
    fts = np.ascontiguousarray(features, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or fts.ndim != 2 or (
            len(fts) != len(pts)):
        raise ValueError(f"points {pts.shape} must be (n, 3) and features "
                         f"{fts.shape} (n, c)")
    if not len(pts):
        raise ValueError("an empty scene has no bounding box")
    lib = _load()
    if not lib:
        order = np.argsort(morton_codes(pts), kind="stable")
        return (order, np.ascontiguousarray(pts[order]),
                np.ascontiguousarray(fts[order]), pts.min(axis=0),
                pts.max(axis=0))
    n, c = len(pts), fts.shape[1]
    lo, hi = np.empty(3, np.float32), np.empty(3, np.float32)
    order = np.empty(n, np.int64)
    pts_out = np.empty((n, 3), np.float32)
    fts_out = np.empty((n, c), np.float32)
    lib.gh_presort(pts, fts, n, c, min(8, os.cpu_count() or 1), lo, hi,
                   order, pts_out, fts_out)
    return order, pts_out, fts_out, lo, hi


def crop_chunks(xyz, rgb, label, mins, span, rows, centers, rgb_norm):
    """``data.s3dis._emit_block`` for every chunk of a room in one threaded
    native pass, its arrays already stacked: chunk k holds the room's points
    ``rows[k]`` ((C, m) int64), Morton-sorted, centred on ``centers[k]``
    ((C, 2) float32, the window's middle in x and y).  ``xyz`` (n, 3)
    float32, ``rgb`` (n, 3), ``label`` (n,), ``mins`` and ``span`` the
    room's (3,) float32; ``rgb_norm`` appends (xyz - mins) / span to the
    colours.  Returns room_blocks' dict, the same bits as the NumPy steps.
    Requires the library (``available()``)."""
    rows = np.ascontiguousarray(rows, np.int64)
    n = len(xyz)
    if (xyz.shape != (n, 3) or rgb.shape != (n, 3) or label.shape != (n,)
            or rows.ndim != 2 or centers.shape != (len(rows), 2)
            or not rows.size or rows.min() < 0 or rows.max() >= n):
        raise ValueError(
            f"xyz {xyz.shape} and rgb {rgb.shape} must be (n, 3), label "
            f"{label.shape} (n,), rows {rows.shape} (C, m) of indices below "
            f"n and centers {centers.shape} (C, 2)")
    chunks, m = rows.shape
    out = dict(points=np.empty((chunks, m, 3), np.float32),
               features=np.empty((chunks, m, 6 if rgb_norm else 3),
                                 np.float32),
               label=np.empty((chunks, m), np.int32),
               mask=np.empty((chunks, m), np.float32),
               index=np.empty((chunks, m), np.int32))
    _load().gh_crop(
        np.ascontiguousarray(xyz, np.float32),
        np.ascontiguousarray(rgb, np.float32),
        np.ascontiguousarray(label, np.int32),
        np.ascontiguousarray(mins, np.float32),
        np.ascontiguousarray(span, np.float32), rows,
        np.ascontiguousarray(centers, np.float32), chunks, m, int(rgb_norm),
        min(8, os.cpu_count() or 1), out["points"], out["features"],
        out["label"], out["mask"], out["index"])
    return out
