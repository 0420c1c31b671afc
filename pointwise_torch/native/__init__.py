"""ctypes bindings for the native grid-hash spatial index (gridhash.cpp).

A copy of ``pointwise_tpu.native`` for the PyTorch package, with one change:
the shared library is built at first use into ``native/_build/`` (ignored by
git), never next to the source.  Without a compiler it falls back to a pure
NumPy implementation (identical results, slower): this is host code, not a
device path.
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
                 "-o", tmp, _SRC],
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
    _lib = lib
    return _lib


def available() -> bool:
    return bool(_load())


class GridIndex:
    """Uniform spatial grid over one point set."""

    def __init__(self, points: np.ndarray, cell_size: float):
        self.points = np.ascontiguousarray(points, np.float32)
        n = len(self.points)
        self.origin = self.points.min(axis=0).astype(np.float32)
        extent = self.points.max(axis=0) - self.origin
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
        q = np.clip(
            ((self.points - self.origin) / self.h).astype(np.int64),
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
        cid = ((int(coords[0]) * int(self.dims[1]) + int(coords[1]))
               * int(self.dims[2]) + int(coords[2]))
        return self.order[self.cell_starts[cid]:self.cell_starts[cid + 1]]

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
