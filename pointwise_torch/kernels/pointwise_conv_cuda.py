"""Pointwise-conv kernels for Hopper: build, bindings, plain versions.

Hand-written kernels, one wrapper each; on a CUDA tensor a wrapper launches
its kernel (``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at
first use into ``kernels/_build/``, ignored by git, and bound through
ctypes); on a CPU tensor it runs the plain PyTorch version of the same
contract.  A CUDA call never falls back to the plain version: a build or
launch failure raises.

  conv_fwd / conv_fwd_plain  forward (csrc/pointwise_conv_fwd.cu), replacing
      ``_fwd_kernel_resident``, ``_fwd_kernel`` and ``_fwd_kernel_csr``, and
      with ``cnt_in`` their external-counts variants
      (``pointwise_conv_pallas_ext``): the means walk ``conv_fwd_means``
      (csrc/pointwise_conv_walk.cuh, tensor cores) then the product
      ``conv_fwd_product`` (``_finalize_tile``'s; csrc/
      pointwise_conv_product.cuh, TMA, mbarriers and wgmma, its tiles from
      ``product_plan``), each with its plain version;
  conv_dw / conv_dw_plain    weight gradient (csrc/pointwise_conv_dw.cu),
      replacing the ``_dw_kernel*`` family: the forward's means walk
      dividing by the forward's counts ``conv_dw_means`` then the product
      ``conv_dw_product`` (``_dw_finalize``'s; the forward's TMA / wgmma
      kernel with xbar^T read M-major, split over the centers by
      ``dw_product_plan``), each with its plain version;
  conv_dx / conv_dx_plain    feature gradient (csrc/pointwise_conv_dx.cu),
      replacing the ``_dx_kernel*`` family: the walk with candidates as rows
      and scaled planes ``conv_dx_sums`` then the product
      ``conv_dx_product`` (``_dx_finalize``'s, the forward's product with
      W transposed), each with its plain version;
  conv_counts / conv_counts_plain  per-cell neighbor counts only
      (csrc/pointwise_conv_counts.cu), replacing ``_counts_kernel``
of pointwise_tpu/kernels/pointwise_conv_pallas.py (see the notes at the top
of each CUDA source).  Each walks, for each row tile of ``TILE`` points, a
list of ``TILE``-point tiles of the other side: every tile (the dense walk,
``tile_ptr=tile_idx=None``) or the bbox-adjacent ones from
``tile_adjacency`` (the CSR walk); each walk CTA of 16 rows walks only the
16-candidate k-steps of its list whose box lies within the radius of its
rows' box (the cull, ``walk_cull_share``).  ``LAUNCHES`` counts the launches
of each kernel and walk mode, ``HOST_SYNCS`` the program's calls that block
the host until the card catches up.

Shared contract (all padded by the op layer, ops/pointwise_conv.py):
  ctr   (B, Ncp, 3) f32  centers; padding and masked centers at -SENTINEL
  pts   (B, Mp, 3)  f32  candidates; padding and masked ones at +SENTINEL
  feats (B, Mp, Cin) f32 or bf16 (the matmul type)
  w     (27, Cin, Cout)  same dtype as feats
  bias  (Cout,) f32
  g     (B, Ncp, Cout) f32, the gradient of y
  cnt   (B, Ncp, 27) f32, the forward's per-cell neighbor counts (dW and dX
        divide by it; the ring strategy passes the counts over all of its
        candidates here, as the TPU's ext-counts backward does)
  cnt_in (B, Ncp, 27) f32 or None: external divisor counts of the forward
  tile_ptr (B*Ncp/TILE + 1,) int32 and tile_idx (nnz,) int32, or None: the
        CSR walk's compact list; center tile (b, row) walks the candidate
        tiles tile_idx[tile_ptr[b*Ncp/TILE + row] : tile_ptr[... + 1]].
        conv_dx walks the transposed list (candidate tile -> center tiles,
        ``tile_adjacency(pts, ctr, radius)``), of length B*Mp/TILE + 1.
conv_fwd returns y (B, Ncp, Cout) f32 and its walk's own cnt; conv_dw
returns dW (27, Cin, Cout) f32; conv_dx returns dX (B, Mp, Cin) f32;
conv_counts returns cnt (B, Ncp, 27) f32, equal bit for bit to conv_fwd's.  Ncp and Mp are
multiples of TILE.  Rounding in bf16 mode follows the TPU op (its
``_pw_bwd``): g is rounded to bf16 before both products, the means as in the
forward, 1/max(cnt, 1) and the per-cell gradient sums Z before the dX
product; every product accumulates in f32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

N_CELLS = 27
# Padding points live here; far enough that no real point is within any
# practical radius, close enough that squared distances stay finite in f32.
SENTINEL = 1.0e6
# Coordinates at or beyond this magnitude are sentinel padding; bbox
# computations ignore them.
_SENTINEL_CUT = 5.0e5

TILE = 64              # center-list row tile and candidate tile (points)
WALK_M = 16            # rows of one walk CTA (csrc/pointwise_conv_walk.cuh)
WALK_K = 16            # candidates of one k-step, the walk's culled group
_BOX_EMPTY = 1.0e9     # a box of padding alone: lo = 1e9 > hi = -1e9
_MAX_SMEM = 232_448    # dynamic shared memory one block may use on sm_90

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD_DIR = os.path.join(_DIR, "_build")
_SOURCES = ("pointwise_conv_fwd.cu", "pointwise_conv_dw.cu",
            "pointwise_conv_dx.cu", "pointwise_conv_counts.cu")
_HEADERS = ("pointwise_conv_common.cuh", "pointwise_conv_walk.cuh",
            "pointwise_conv_product.cuh")
# The widest Cin (forward, dW) and Cout (forward, dX) the kernels take (the
# card tests hold them to it); csrc/pointwise_conv_walk.cuh's MAX_WIDTH.
MAX_WIDTH = 1024
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: the product encodes its TMA tensor maps through the
# CUDA driver API's cuTensorMapEncodeTiled
_NVCC_LIBS = ("-lcuda",)

# The bf16 product's plan (csrc/pointwise_conv_product.cuh, GemmTile): its
# N tiles, k-step, consumer warpgroups and the shared memory its ring may
# fill.  product_plan mirrors the kernel's arithmetic; the kernel refuses a
# launch whose row tile or stages differ from its own.
PRODUCT_BN = (8, 16, 32, 64, 128, 256)
_PRODUCT_BK = 64
_PRODUCT_CONSUMERS = 2
_PRODUCT_RING_BYTES = 230_400
_PRODUCT_MAX_STAGES = 8
# dW's product (tag DwProduct of the same kernel) cuts the centers into
# slices to fill the card: it aims at this many work units (tiles x
# slices), one per SM of an H100; a constant, so that dW's bits never
# depend on the card (csrc/pointwise_conv_dw.cu's DW_UNITS).
DW_UNITS = 132

# Kernel launches per walk mode: the wrapper adds one per launch, nowhere
# else.  Callers reset them to show that a run went through the kernel.
LAUNCHES = {"fwd_dense": 0, "fwd_csr": 0, "fwd_product": 0,
            "dw_dense": 0, "dw_csr": 0, "dw_product": 0,
            "dx_dense": 0, "dx_csr": 0, "dx_product": 0,
            "counts_dense": 0, "counts_csr": 0,
            "fwd_ext_dense": 0, "fwd_ext_csr": 0}
# The program's calls that block the host on the card, by site; each site
# calls ``count_sync`` once per blocking call, on any device (the CPU tests
# see the same counts as the card):
#   tile_boxes         the upload of the sentinel bound in
#                      ``_row_tile_boxes`` (a pageable copy of a Python
#                      scalar; two a CSR tile list)
#   tile_lists         the nonzero that sizes a CSR tile list
#                      (``_boxes_adjacency``)
#   engine_put         the streaming engine's pageable copy of a chunk's
#                      index array to the device
#   engine_resident    its upload of the resident scene (xyz, features)
#   engine_fetch       its fetch of a chunk's logits
#   subblock_cap       ``_subblock_conv``'s branch on the fullest group
#   check_coordinates  ``_check_coordinates``' test of the coordinates
HOST_SYNCS = {"tile_boxes": 0, "tile_lists": 0, "engine_put": 0,
              "engine_resident": 0, "engine_fetch": 0, "subblock_cap": 0,
              "check_coordinates": 0}
# The counters ``reset_launches`` zeroes: the two above, and those that a
# layer above keeps beside its own sites (the op layer's ``DW_XBAR``).
COUNTERS = [LAUNCHES, HOST_SYNCS]
# Library loads in this process (a build from source, or loading a library
# built earlier from the same source), the seconds they took, and the
# compiler's resource report (registers, shared memory, spills).  Every
# kernel declares ``__launch_bounds__``, so ptxas holds its registers to what
# a CTA of that size can have; shared memory is checked per launch.
LIBRARY = {"loads": 0, "seconds": 0.0, "ptxas": ""}

_libs: dict = {}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """The SM count of a CUDA device (asked once per device)."""
    return _sm_count_of(torch.cuda.current_device() if dev.index is None
                        else dev.index)


def reset_launches() -> None:
    """Zero every counter of ``COUNTERS``."""
    for counter in COUNTERS:
        for k in counter:
            counter[k] = 0


def count_sync(site: str) -> None:
    """Count one call at ``site`` (a key of ``HOST_SYNCS``) that blocks the
    host until the card has run what was queued before it."""
    HOST_SYNCS[site] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (shutil.which("nvcc"),
                 home and os.path.join(home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _so_path(src: str) -> str:
    h = hashlib.sha1(" ".join(_NVCC_FLAGS + _NVCC_LIBS).encode())
    for name in (src, *_HEADERS):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(_BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")


def build_libraries() -> dict:
    """Build every kernel source missing from the build directory (one
    ``nvcc`` per source, all started together) and load them all.  Returns
    {source stem: ctypes library}.  Raises on any compile or load error."""
    if len(_libs) == len(_SOURCES):
        return _libs
    t0 = time.perf_counter()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = []
    for src in _SOURCES:
        so = _so_path(src)
        if os.path.exists(so):
            continue
        # temp file + atomic rename: a concurrent process never loads a
        # half-written library
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src),
               *_NVCC_LIBS]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}      # source: its compiler report, from this build or its log
    failed = []
    for src, so, tmp, p in procs:
        out, _ = p.communicate()
        logs[src] = out
        if p.returncode != 0:
            failed.append(f"{src}:\n{out[-4000:]}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, so)
        with open(so + ".log", "w") as f:
            f.write(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for src in _SOURCES:
        so = _so_path(src)
        if src not in logs and os.path.exists(so + ".log"):
            with open(so + ".log") as f:
                logs[src] = f.read()
        stem = os.path.splitext(src)[0]
        _libs[stem] = _bind(stem, ctypes.CDLL(so))
    LIBRARY["loads"] += 1
    LIBRARY["seconds"] += time.perf_counter() - t0
    LIBRARY["ptxas"] = "".join(logs.get(src, "") for src in _SOURCES)
    return _libs


def ptxas_kernels(log: str, match: str) -> list:
    """The ptxas report (``LIBRARY["ptxas"]``) of each kernel whose mangled
    name holds ``match``: {kernel, registers, static_smem, stack,
    spill_stores, spill_loads} (bytes), and the report's lines about it
    that name ``setmaxnreg``."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(kernel=m.group(1), notes=[]) if match in m.group(1) \
                else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            sm = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m[1]),
                       static_smem=int(sm[1]) if sm else 0)
        if "setmaxnreg" in ln:
            cur["notes"].append(ln.strip())
    return out


def _bind(stem: str, lib):
    vp, ci, cf, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
    if stem == "pointwise_conv_fwd":
        lib.pw_conv_fwd_means.argtypes = [vp] * 9 + [ci] * 5 + [cf, cf, ci,
                                                                vp]
        lib.pw_conv_fwd_means.restype = ci
        lib.pw_conv_fwd_product.argtypes = [vp, ci, vp, ci, vp, vp] \
            + [ci] * 8 + [vp]
        lib.pw_conv_fwd_product.restype = ci
        lib.pw_conv_smem_bytes.argtypes = [ci, ci]
        lib.pw_conv_smem_bytes.restype = ll
        lib.pw_conv_pack_elems.argtypes = [ci] * 4
        lib.pw_conv_pack_elems.restype = ll
        lib.pw_conv_tile.restype = ci
        lib.pw_product_encode.argtypes = [vp, ci, vp, ci] + [ci] * 4
        lib.pw_product_encode.restype = ci
        lib.pw_conv_max_width.restype = ci
        if lib.pw_conv_tile() != TILE:
            raise RuntimeError(f"kernel TILE {lib.pw_conv_tile()} != {TILE}")
        if lib.pw_conv_max_width() != MAX_WIDTH:
            raise RuntimeError(f"kernel MAX_WIDTH {lib.pw_conv_max_width()} "
                               f"!= {MAX_WIDTH}")
    elif stem == "pointwise_conv_dw":
        lib.pw_conv_dw_means.argtypes = [vp] * 8 + [ci] * 5 + [cf, cf, ci,
                                                              vp]
        lib.pw_conv_dw_means.restype = ci
        lib.pw_conv_dw_product.argtypes = [vp, ci, vp, vp, vp, vp] \
            + [ci] * 10 + [vp]
        lib.pw_conv_dw_product.restype = ci
        lib.pw_dw_smem_bytes.argtypes = [ci, ci]
        lib.pw_dw_smem_bytes.restype = ll
        lib.pw_dw_pack_elems.argtypes = [ci] * 4
        lib.pw_dw_pack_elems.restype = ll
    elif stem == "pointwise_conv_counts":
        lib.pw_conv_counts.argtypes = [vp] * 5 + [ci] * 3 + [cf, cf, vp]
        lib.pw_conv_counts.restype = ci
    else:
        lib.pw_conv_dx_sums.argtypes = [vp] * 9 + [ci] * 5 + [cf, cf, ci, vp]
        lib.pw_conv_dx_sums.restype = ci
        lib.pw_conv_dx_product.argtypes = [vp, ci, vp, ci, vp] + [ci] * 8 \
            + [vp]
        lib.pw_conv_dx_product.restype = ci
        lib.pw_dx_smem_bytes.argtypes = [ci, ci]
        lib.pw_dx_smem_bytes.restype = ll
        lib.pw_dx_pack_elems.argtypes = [ci] * 4
        lib.pw_dx_pack_elems.restype = ll
        lib.pw_dx_scale_elems.argtypes = [ci] * 3
        lib.pw_dx_scale_elems.restype = ll
    return lib


def _inv_cell(radius: float) -> float:
    return float(np.float32(3.0 / (2.0 * radius)))


def _check_walk(ctr, pts, tile_ptr, tile_idx, rows: str = "ctr"):
    """Coordinates and the tile list; ``rows`` names the side whose tiles
    the list is indexed by ("ctr": forward and dW, "pts": dX)."""
    B, Ncp, _ = ctr.shape
    Mp = pts.shape[1]
    if ctr.shape != (B, Ncp, 3) or pts.shape != (B, Mp, 3):
        raise ValueError(f"ctr/pts must be (B, N, 3), got {tuple(ctr.shape)} "
                         f"and {tuple(pts.shape)}")
    if Ncp % TILE or Mp % TILE:
        raise ValueError(f"Ncp={Ncp} and Mp={Mp} must be multiples of {TILE}")
    if ctr.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError("ctr and pts must be float32")
    if (tile_ptr is None) != (tile_idx is None):
        raise ValueError("pass tile_ptr and tile_idx together (or neither: "
                         "dense walk)")
    if tile_ptr is not None:
        nR, nC = (Ncp // TILE, Mp // TILE) if rows == "ctr" else (
            Mp // TILE, Ncp // TILE)
        if tile_ptr.shape != (B * nR + 1,) or tile_idx.ndim != 1 \
                or tile_idx.numel() > B * nR * nC \
                or tile_ptr.dtype != torch.int32 \
                or tile_idx.dtype != torch.int32:
            raise ValueError(f"tile_ptr must be int32 ({B * nR + 1},) and "
                             f"tile_idx int32 (at most {B * nR * nC},)")
    return B, Ncp, Mp


def _check_counts(cnt, B, Ncp, name="cnt"):
    if cnt.shape != (B, Ncp, N_CELLS) or cnt.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 ({B}, {Ncp}, 27), got "
                         f"{cnt.dtype} {tuple(cnt.shape)}")


def _check_grad_inputs(g, cnt, B, Ncp):
    if g.ndim != 3 or g.shape[:2] != (B, Ncp) or g.dtype != torch.float32:
        raise ValueError(f"g must be float32 (B={B}, Ncp={Ncp}, Cout), got "
                         f"{g.dtype} {tuple(g.shape)}")
    _check_counts(cnt, B, Ncp)


def _check(ctr, pts, feats, w, bias, tile_ptr, tile_idx, cnt_in=None):
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx)
    if cnt_in is not None:
        _check_counts(cnt_in, B, Ncp, "cnt_in")
    cin, cout = w.shape[1], w.shape[2]
    if feats.shape != (B, Mp, cin) or w.shape != (N_CELLS, cin, cout):
        raise ValueError(f"feats {tuple(feats.shape)} / w {tuple(w.shape)} "
                         f"do not match (B={B}, Mp={Mp}, 27, Cin, Cout)")
    if bias.shape != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if feats.dtype not in (torch.float32, torch.bfloat16) \
            or w.dtype != feats.dtype:
        raise TypeError(f"feats and w must share float32 or bfloat16, got "
                        f"{feats.dtype} and {w.dtype}")
    return B, Ncp, Mp, cin, cout


def _check_dw(ctr, pts, feats, g, cnt, tile_ptr, tile_idx):
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx)
    _check_grad_inputs(g, cnt, B, Ncp)
    if feats.ndim != 3 or feats.shape[:2] != (B, Mp) \
            or feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats must be float32 or bfloat16 (B={B}, Mp={Mp}, "
                         f"Cin), got {feats.dtype} {tuple(feats.shape)}")
    return B, Ncp, Mp, feats.shape[2], g.shape[2]


def _check_dx_sums(ctr, pts, g, cnt, tile_ptr, tile_idx, dtype):
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx, rows="pts")
    _check_grad_inputs(g, cnt, B, Ncp)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return B, Ncp, Mp, g.shape[2]


def _check_dx(ctr, pts, g, cnt, w, tile_ptr, tile_idx):
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx, rows="pts")
    _check_grad_inputs(g, cnt, B, Ncp)
    cin, cout = w.shape[1], w.shape[2]
    if w.shape != (N_CELLS, cin, cout) or g.shape[2] != cout:
        raise ValueError(f"w {tuple(w.shape)} does not match g "
                         f"{tuple(g.shape)}: (27, Cin, Cout)")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    return B, Ncp, Mp, cin, cout


def _check_device(tensors, dev):
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, err):
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult "
                           f"{-err}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _smem(need, what):
    if need > _MAX_SMEM:
        raise ValueError(f"{what} needs {need} B of shared memory per block "
                         f"(limit {_MAX_SMEM})")


def _width(cin, cout=None):
    for name, n in (("Cin", cin), ("Cout", cout)):
        if n is not None and n > MAX_WIDTH:
            raise ValueError(f"{name}={n} is wider than the {MAX_WIDTH} "
                             f"channels the kernels take")


def _check_means(ctr, pts, feats, tile_ptr, tile_idx, cnt_in):
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx)
    if cnt_in is not None:
        _check_counts(cnt_in, B, Ncp, "cnt_in")
    if feats.ndim != 3 or feats.shape[:2] != (B, Mp) \
            or feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feats must be float32 or bfloat16 (B={B}, Mp={Mp}, "
                         f"Cin), got {feats.dtype} {tuple(feats.shape)}")
    return B, Ncp, Mp, feats.shape[2]


def _pack_scratch(lib_elems, cin, bf16, B, Mp, dev):
    """The walk's pack scratch: the bf16 terms of the features, then the
    boxes of the candidates' k-steps that the walk's cull reads."""
    return torch.empty(lib_elems(cin, bf16, B, Mp), dtype=torch.bfloat16,
                       device=dev)


def conv_fwd_means(ctr, pts, feats, radius: float, tile_ptr=None,
                   tile_idx=None, cnt_in=None):
    """The forward's means walk: (xbar (B*Ncp, 27*Cin) in the features'
    type, the means per cell divided by max(cnt, 1) or by max(cnt_in, 1) and
    rounded; cnt (B, Ncp, 27) f32, the walk's own counts).  On a CUDA tensor
    it launches the tensor-core walk (xbar is then a view of a workspace
    whose rows are padded to a multiple of 8), on a CPU tensor it runs
    ``conv_fwd_means_plain``."""
    if ctr.device.type == "cpu":
        return conv_fwd_means_plain(ctr, pts, feats, radius, tile_ptr,
                                    tile_idx, cnt_in)
    if ctr.device.type != "cuda":
        raise ValueError(f"unsupported device {ctr.device}")
    B, Ncp, Mp, cin = _check_means(ctr, pts, feats, tile_ptr, tile_idx,
                                   cnt_in)
    _check_device([ctr, pts, feats, tile_ptr, tile_idx, cnt_in], ctr.device)
    _width(cin)
    lib = build_libraries()["pointwise_conv_fwd"]
    bf16 = int(feats.dtype == torch.bfloat16)
    _smem(lib.pw_conv_smem_bytes(cin, bf16), f"Cin={cin}")
    dev = ctr.device
    k = N_CELLS * cin
    ldx = round_up(k, 8)
    xbar = torch.empty((B * Ncp, ldx), dtype=feats.dtype, device=dev)
    cnt = torch.empty((B, Ncp, N_CELLS), dtype=torch.float32, device=dev)
    packed = _pack_scratch(lib.pw_conv_pack_elems, cin, bf16, B, Mp, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("pw_conv_fwd_means", lib.pw_conv_fwd_means(
            ctr.data_ptr(), pts.data_ptr(), feats.data_ptr(),
            packed.data_ptr(), _ptr(tile_ptr), _ptr(tile_idx), _ptr(cnt_in),
            cnt.data_ptr(), xbar.data_ptr(), ldx, B, Ncp, Mp, cin,
            float(radius), _inv_cell(radius), bf16, stream))
    LAUNCHES[("fwd_ext_" if cnt_in is not None else "fwd_")
             + ("dense" if tile_ptr is None else "csr")] += 1
    return xbar[:, :k], cnt


def _check_product(a, w, n_k: int, what: str):
    """The A operand of a product (rows, n_k) and the weights: same type,
    rows a multiple of TILE, unit column stride and, in bf16, a row stride
    that is a multiple of 8 and a 16-byte aligned address (a TMA tensor
    map's).  Returns bf16."""
    rows = a.shape[0] if a.ndim == 2 else -1
    if w.ndim != 3 or w.shape[0] != N_CELLS or a.ndim != 2 \
            or a.shape[1] != n_k or rows % TILE:
        raise ValueError(f"{what} {tuple(a.shape)} / w {tuple(w.shape)} do "
                         f"not match (rows % {TILE} == 0, {n_k}) x (27, Cin, "
                         f"Cout)")
    if a.dtype != w.dtype or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} and w must share float32 or bfloat16, got "
                        f"{a.dtype} and {w.dtype}")
    bf16 = int(w.dtype == torch.bfloat16)
    if a.stride(1) != 1 or a.stride(0) % (8 if bf16 else 1) \
            or (bf16 and a.data_ptr() % 16):
        raise ValueError(f"{what} rows must be contiguous, their stride a "
                         f"multiple of 8 and their start 16-byte aligned in "
                         f"bfloat16")
    _check_device([w], a.device)              # a's strides checked above
    return bf16


def product_plan(rows: int, n: int, k: int, sms: int) -> dict:
    """The bf16 product's tiles for y (rows, n) = a (rows, k) . w, as
    csrc/pointwise_conv_product.cuh lays them out: the N tile ``bn`` (the
    smallest of ``PRODUCT_BN`` that holds n, else 256 in ceil(n / 256)
    tiles), the row tile ``bm`` (256 rows, two m64 sub-tiles per consumer
    warpgroup, up to N = 128; 128 at N = 256), the ring's ``stages`` and the
    kernel's dynamic shared memory ``smem``; the persistent ``grid`` (one
    CTA per SM, at most one per tile) of ``sms`` SMs.  ``w_l2_bytes``: the
    bytes of W the tiles read from L2 (each row tile reads all of W once;
    the columns past n are filled, not read); ``a_l2_bytes``: A's (each N
    tile reads all of A).  Nothing here changes a bit of the result: the
    order of every sum depends on k alone."""
    bn = next((b for b in PRODUCT_BN if b >= n), PRODUCT_BN[-1])
    bm = 64 * (2 if bn <= 128 else 1) * _PRODUCT_CONSUMERS
    stage = (bm + bn) * _PRODUCT_BK * 2
    stages = min(_PRODUCT_MAX_STAGES, _PRODUCT_RING_BYTES // stage)
    n_tiles = -(-n // bn)
    row_tiles = -(-rows // bm)
    tiles = row_tiles * n_tiles
    return dict(bm=bm, bn=bn, stages=stages, cluster=1,
                smem=1024 + stages * stage + 16 * stages, n_tiles=n_tiles,
                row_tiles=row_tiles, tiles=tiles, grid=min(tiles, sms),
                k_steps=-(-k // _PRODUCT_BK),
                w_l2_bytes=row_tiles * k * n * 2,
                a_l2_bytes=n_tiles * rows * k * 2)


def product_operand(w, kind: str):
    """The B operand the bf16 product reads for W (27, Cin, Cout): B^T,
    K-major (N, round_up(K, 8)), so that wgmma reads both operands without the
    transpose bit and a TMA box is 64 contiguous k of N columns.  ``fwd``:
    W.reshape(27*Cin, Cout)^T (N = Cout); ``dx``: (W^T per cell)^T, W laid
    out (Cin, 27*Cout) (N = Cin).  One copy of W per call (830 KB at 124
    wide); the columns past K are never read (the tensor map ends at K) and
    are left unset."""
    if kind == "fwd":
        src = w.reshape(-1, w.shape[2]).t()
    else:
        src = w.permute(1, 0, 2)
    n, k = src.shape[0], src[0].numel()
    out = w.new_empty((n, round_up(k, 8)))
    out[:, :k].view(src.shape).copy_(src)
    return out


def _product(kind, a, w, bias):
    """Launch the product kernel of ``kind`` (``fwd`` or ``dx``): y (rows,
    N) f32 = a . B (+ bias), B = W.reshape(27*Cin, Cout) (fwd) or W^T per
    cell (dx), in a's type.  bf16: the TMA / wgmma kernel on
    ``product_operand`` with ``product_plan``'s tile and grid; f32: the
    CUDA-core kernel on B (K, N).  No launch for zero rows."""
    rows, k = a.shape
    n = w.shape[2] if kind == "fwd" else w.shape[1]
    y = torch.empty((rows, n), dtype=torch.float32, device=a.device)
    if rows == 0:
        return y
    lib = build_libraries()[f"pointwise_conv_{kind}"]
    bf16 = int(w.dtype == torch.bfloat16)
    if bf16:
        wk = product_operand(w, kind)
        plan = product_plan(rows, n, k, sm_count(a.device))
        tile = [plan[key] for key in ("bn", "bm", "stages", "grid")]
    else:
        wk = (w.reshape(k, n) if kind == "fwd"
              else w.transpose(1, 2).reshape(k, n)).contiguous()
        tile = [0, 0, 0, 0]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "fwd":
            _launch("pw_conv_fwd_product", lib.pw_conv_fwd_product(
                a.data_ptr(), a.stride(0), wk.data_ptr(), wk.stride(0),
                bias.data_ptr(), y.data_ptr(), rows, k, n, bf16, *tile,
                stream))
        else:
            _launch("pw_conv_dx_product", lib.pw_conv_dx_product(
                a.data_ptr(), a.stride(0), wk.data_ptr(), wk.stride(0),
                y.data_ptr(), rows, k, n, bf16, *tile, stream))
    LAUNCHES[f"{kind}_product"] += 1
    return y


def conv_fwd_product(xbar, w, bias):
    """y (rows, Cout) f32 = xbar . W + bias: xbar (rows, 27*Cin) in W's type
    (rows a multiple of 64; unit column stride), W (27, Cin, Cout), bias
    (Cout,) f32 added after the f32 sum.  Launches the product kernel on
    CUDA tensors (tensor cores in bf16), runs ``conv_fwd_product_plain`` on
    CPU tensors."""
    if xbar.device.type == "cpu":
        return conv_fwd_product_plain(xbar, w, bias)
    if xbar.device.type != "cuda":
        raise ValueError(f"unsupported device {xbar.device}")
    _check_product(xbar, w, N_CELLS * w.shape[1], "xbar")
    cin, cout = w.shape[1], w.shape[2]
    if bias.shape != (cout,) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 ({cout},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    _check_device([bias], xbar.device)
    _width(cin, cout)
    return _product("fwd", xbar, w, bias)


def conv_fwd(ctr, pts, feats, w, bias, radius: float, tile_ptr=None,
             tile_idx=None, cnt_in=None):
    """Forward conv (see the module docstring); with ``cnt_in`` the means
    divide by those external counts.  On CUDA tensors the means walk and
    the product kernel (``conv_fwd_means``, ``conv_fwd_product``), on CPU
    tensors ``conv_fwd_plain``."""
    if ctr.device.type == "cpu":
        return conv_fwd_plain(ctr, pts, feats, w, bias, radius, tile_ptr,
                              tile_idx, cnt_in)
    B, Ncp, _, _, cout = _check(ctr, pts, feats, w, bias, tile_ptr,
                                tile_idx, cnt_in)
    _width(w.shape[1], cout)
    xbar, cnt = conv_fwd_means(ctr, pts, feats, radius, tile_ptr, tile_idx,
                               cnt_in)
    return conv_fwd_product(xbar, w, bias).view(B, Ncp, cout), cnt


def conv_counts(ctr, pts, radius: float, tile_ptr=None, tile_idx=None):
    """Per-cell neighbor counts (B, Ncp, 27) f32 of the forward's walk, with
    no features (see the module docstring).  Launches the CUDA kernel on
    CUDA tensors, runs ``conv_counts_plain`` on CPU tensors."""
    if ctr.device.type == "cpu":
        return conv_counts_plain(ctr, pts, radius, tile_ptr, tile_idx)
    if ctr.device.type != "cuda":
        raise ValueError(f"unsupported device {ctr.device}")
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx)
    _check_device([ctr, pts, tile_ptr, tile_idx], ctr.device)
    if pts.data_ptr() % 16:   # the kernel stages candidates 16 bytes a copy
        pts = pts.clone()
    lib = build_libraries()["pointwise_conv_counts"]
    cnt = torch.empty((B, Ncp, N_CELLS), dtype=torch.float32,
                      device=ctr.device)
    with torch.cuda.device(ctr.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("pw_conv_counts", lib.pw_conv_counts(
            ctr.data_ptr(), pts.data_ptr(), _ptr(tile_ptr), _ptr(tile_idx),
            cnt.data_ptr(), B, Ncp, Mp, float(radius), _inv_cell(radius),
            stream))
    LAUNCHES["counts_dense" if tile_ptr is None else "counts_csr"] += 1
    return cnt


def dw_product_plan(rows: int, k: int, cout: int, sms: int) -> dict:
    """dW's product plan for dW (k, cout) = xbar (rows, k)^T . round(g),
    as csrc/pointwise_conv_dw.cu's ``dw_plan`` lays it out: the forward's
    tile rule with dW's k = 27*Cin as the rows and Cout as n (``bm``,
    ``bn``, ``stages``, ``smem``, ``tiles``), the centers cut into
    ``slices`` of ``chunk`` centers (a multiple of 64; the last slice may be
    short): as many as fit ``DW_UNITS`` work units (at least one, at most
    one per 64-center k-step), so that the plan and dW's bits never depend
    on the card; ``units`` = tiles x slices, the persistent ``grid`` (at
    most one CTA per unit and per SM of ``sms``), and ``part_bytes``: the
    slices' f32 partial sums (none for one slice).  The kernel refuses a
    launch whose slices or chunk differ from its own."""
    tile = product_plan(k, cout, rows, sms)
    k_steps = -(-rows // _PRODUCT_BK)
    slices = max(1, min(k_steps, DW_UNITS // tile["tiles"]))
    chunk_steps = -(-k_steps // slices)
    slices = -(-k_steps // chunk_steps)
    units = tile["tiles"] * slices
    return dict(bm=tile["bm"], bn=tile["bn"], stages=tile["stages"],
                smem=tile["smem"], tiles=tile["tiles"], k_steps=k_steps,
                slices=slices, chunk=chunk_steps * _PRODUCT_BK, units=units,
                grid=min(units, sms),
                part_bytes=(slices * k * cout * 4 if slices > 1 else 0))


@functools.lru_cache(maxsize=1024)
def _dw_launch_plan(rows: int, k: int, cout: int, sms: int) -> tuple:
    """(bn, bm, stages, slices, chunk, grid) of ``dw_product_plan``, as the
    kernel takes them (cached: the wrapper asks once per shape)."""
    plan = dw_product_plan(rows, k, cout, sms)
    return tuple(plan[key] for key in ("bn", "bm", "stages", "slices",
                                       "chunk", "grid"))


def conv_dw_means(ctr, pts, feats, cnt, radius: float, tile_ptr=None,
                  tile_idx=None):
    """dW's means walk: xbar (B*Ncp, 27*Cin) in the features' type, the
    forward's cell means divided by the forward's counts ``cnt`` (max(cnt,
    1), f32) and rounded.  On a CUDA tensor it launches the tensor-core walk
    (xbar is then a view of a workspace whose rows are padded to a multiple
    of 8), on a CPU tensor it runs ``conv_dw_means_plain``."""
    if ctr.device.type == "cpu":
        return conv_dw_means_plain(ctr, pts, feats, cnt, radius, tile_ptr,
                                   tile_idx)
    if ctr.device.type != "cuda":
        raise ValueError(f"unsupported device {ctr.device}")
    B, Ncp, Mp, cin = _check_means(ctr, pts, feats, tile_ptr, tile_idx, cnt)
    _check_device([ctr, pts, feats, cnt, tile_ptr, tile_idx], ctr.device)
    _width(cin)
    lib = build_libraries()["pointwise_conv_dw"]
    bf16 = int(feats.dtype == torch.bfloat16)
    _smem(lib.pw_dw_smem_bytes(cin, bf16), f"Cin={cin}")
    dev = ctr.device
    k = N_CELLS * cin
    ldx = round_up(k, 8)
    xbar = torch.empty((B * Ncp, ldx), dtype=feats.dtype, device=dev)
    packed = _pack_scratch(lib.pw_dw_pack_elems, cin, bf16, B, Mp, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("pw_conv_dw_means", lib.pw_conv_dw_means(
            ctr.data_ptr(), pts.data_ptr(), feats.data_ptr(),
            packed.data_ptr(), _ptr(tile_ptr), _ptr(tile_idx),
            cnt.data_ptr(), xbar.data_ptr(), ldx, B, Ncp, Mp, cin,
            float(radius), _inv_cell(radius), bf16, stream))
    LAUNCHES["dw_dense" if tile_ptr is None else "dw_csr"] += 1
    return xbar[:, :k]


def _check_dw_product(xbar, g):
    if g.ndim != 2 or g.dtype != torch.float32 or xbar.ndim != 2 \
            or g.shape[0] != xbar.shape[0] or xbar.shape[1] % N_CELLS \
            or xbar.shape[0] % TILE:
        raise ValueError(f"xbar {tuple(xbar.shape)} / g {g.dtype} "
                         f"{tuple(g.shape)} do not match (rows % {TILE} == 0, "
                         f"27*Cin) and float32 (rows, Cout)")
    if xbar.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xbar must be float32 or bfloat16, got {xbar.dtype}")
    return xbar.shape[1] // N_CELLS, g.shape[1]


def conv_dw_product(xbar, g):
    """dW (27, Cin, Cout) f32 = xbar^T . round(g) over all rows: xbar (rows,
    27*Cin) in the matmul type (rows a multiple of 64; unit column stride,
    a row stride that is a multiple of 8 and a 16-byte aligned start in
    bf16), g (rows, Cout) f32, rounded to xbar's type.  Launches the
    product kernels on CUDA tensors (in bf16 g's pack, the TMA / wgmma
    product over ``dw_product_plan``'s slices of the rows, and a
    fixed-order reduce of the slices), runs ``conv_dw_product_plain`` on
    CPU tensors."""
    if xbar.device.type == "cpu":
        return conv_dw_product_plain(xbar, g)
    if xbar.device.type != "cuda":
        raise ValueError(f"unsupported device {xbar.device}")
    cin, cout = _check_dw_product(xbar, g)
    bf16 = int(xbar.dtype == torch.bfloat16)
    if xbar.stride(1) != 1 or xbar.stride(0) % (8 if bf16 else 1) \
            or (bf16 and xbar.data_ptr() % 16):
        raise ValueError("xbar rows must be contiguous, their stride a "
                         "multiple of 8 and their start 16-byte aligned in "
                         "bfloat16")
    _check_device([g], xbar.device)
    lib = build_libraries()["pointwise_conv_dw"]
    dev = xbar.device
    rows, k = xbar.shape
    plan = _dw_launch_plan(rows, k, cout, sm_count(dev))
    # one workspace: round(g) K-major (Cout, rows) bf16, then the slices'
    # partial sums (slices, K, Cout) f32
    gt_bytes = round_up(cout * rows * 2, 256) if bf16 else 0
    ws = torch.empty(gt_bytes + (plan[3] * k * cout * 4 if plan[3] > 1
                                 else 0), dtype=torch.uint8, device=dev)
    dw = torch.empty((N_CELLS, cin, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("pw_conv_dw_product", lib.pw_conv_dw_product(
            xbar.data_ptr(), xbar.stride(0), g.data_ptr(), ws.data_ptr(),
            ws.data_ptr() + gt_bytes, dw.data_ptr(), rows, k, cout, bf16,
            *plan, stream))
    LAUNCHES["dw_product"] += 1
    return dw


def conv_dw(ctr, pts, feats, g, cnt, radius: float, tile_ptr=None,
            tile_idx=None):
    """Weight gradient dW (27, Cin, Cout) f32 of the forward with these
    inputs and the forward's counts ``cnt`` (see the module docstring).
    On CUDA tensors the means walk and the product kernels
    (``conv_dw_means``, ``conv_dw_product``), on CPU tensors
    ``conv_dw_plain``."""
    if ctr.device.type == "cpu":
        return conv_dw_plain(ctr, pts, feats, g, cnt, radius, tile_ptr,
                             tile_idx)
    B, Ncp, _, _, cout = _check_dw(ctr, pts, feats, g, cnt, tile_ptr,
                                   tile_idx)
    xbar = conv_dw_means(ctr, pts, feats, cnt, radius, tile_ptr, tile_idx)
    return conv_dw_product(xbar, g.view(B * Ncp, cout))


def conv_dx_sums(ctr, pts, g, cnt, radius: float, tile_ptr=None,
                 tile_idx=None, dtype=torch.float32):
    """dX's per-cell gradient sums: Z (B*Mp, 27*Cout) in ``dtype`` (the
    matmul type), Z[j, k] the f32 sum over the in-ball centers i of cell k
    of round(1/max(cnt_ik, 1)) * round(g_i), rounded.  ``tile_ptr`` /
    ``tile_idx`` is the transposed list, candidate tile -> center tiles.
    On a CUDA tensor it launches the tensor-core walk (Z is then a view of
    a workspace whose rows are padded to a multiple of 8), on a CPU tensor
    it runs ``conv_dx_sums_plain``."""
    if ctr.device.type == "cpu":
        return conv_dx_sums_plain(ctr, pts, g, cnt, radius, tile_ptr,
                                  tile_idx, dtype)
    if ctr.device.type != "cuda":
        raise ValueError(f"unsupported device {ctr.device}")
    B, Ncp, Mp, cout = _check_dx_sums(ctr, pts, g, cnt, tile_ptr, tile_idx,
                                      dtype)
    _check_device([ctr, pts, g, cnt, tile_ptr, tile_idx], ctr.device)
    _width(None, cout)
    lib = build_libraries()["pointwise_conv_dx"]
    bf16 = int(dtype == torch.bfloat16)
    _smem(lib.pw_dx_smem_bytes(cout, bf16), f"Cout={cout}")
    dev = ctr.device
    k = N_CELLS * cout
    ldz = round_up(k, 8)
    z = torch.empty((B * Mp, ldz), dtype=dtype, device=dev)
    # workspaces: the packed terms of g and of the centers' scales
    packed = _pack_scratch(lib.pw_dx_pack_elems, cout, bf16, B, Ncp, dev)
    scl = torch.empty(lib.pw_dx_scale_elems(bf16, B, Ncp),
                      dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("pw_conv_dx_sums", lib.pw_conv_dx_sums(
            pts.data_ptr(), ctr.data_ptr(), g.data_ptr(), cnt.data_ptr(),
            packed.data_ptr(), scl.data_ptr(), _ptr(tile_ptr),
            _ptr(tile_idx), z.data_ptr(), ldz, B, Mp, Ncp, cout,
            float(radius), _inv_cell(radius), bf16, stream))
    LAUNCHES["dx_dense" if tile_ptr is None else "dx_csr"] += 1
    return z[:, :k]


def conv_dx_product(z, w):
    """dX (rows, Cin) f32 = Z . W^T per cell: Z (rows, 27*Cout) in W's type
    (rows a multiple of 64; unit column stride), W (27, Cin, Cout).  The
    forward's product kernel with W transposed and no bias on CUDA tensors
    (tensor cores in bf16), ``conv_dx_product_plain`` on CPU tensors."""
    if z.device.type == "cpu":
        return conv_dx_product_plain(z, w)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    _check_product(z, w, N_CELLS * w.shape[2], "z")
    return _product("dx", z, w, None)


def conv_dx(ctr, pts, g, cnt, w, radius: float, tile_ptr=None,
            tile_idx=None):
    """Feature gradient dX (B, Mp, Cin) f32 (see the module docstring);
    ``tile_ptr``/``tile_idx`` is the transposed list, candidate tile ->
    center tiles.  On CUDA tensors the sums walk and the product kernel
    (``conv_dx_sums``, ``conv_dx_product``), on CPU tensors
    ``conv_dx_plain``."""
    if ctr.device.type == "cpu":
        return conv_dx_plain(ctr, pts, g, cnt, w, radius, tile_ptr, tile_idx)
    B, _, Mp, cin, _ = _check_dx(ctr, pts, g, cnt, w, tile_ptr, tile_idx)
    z = conv_dx_sums(ctr, pts, g, cnt, radius, tile_ptr, tile_idx, w.dtype)
    return conv_dx_product(z, w).view(B, Mp, cin)


# ---- plain versions (the CPU path and the card's yardstick) -------------


def _walk(tile_ptr, tile_idx, B, n_rows, n_cols, dev):
    """(b, row, listed column tiles) for every row tile that lists any."""
    all_tiles = torch.arange(n_cols, device=dev)
    ptr_h = None if tile_ptr is None else tile_ptr.cpu().tolist()
    for b in range(B):
        for row in range(n_rows):
            if tile_ptr is None:
                tiles = all_tiles
            else:
                i = b * n_rows + row
                tiles = tile_idx[ptr_h[i]:ptr_h[i + 1]].long()
            if tiles.numel():
                yield b, row, tiles


def _pair_codes(rel, radius: float):
    """Cell codes of candidate - center offsets ``rel`` (..., 3) and the
    in-ball mask, in the kernels' order of f32 operations."""
    r = torch.tensor(radius, dtype=torch.float32)
    inv = torch.tensor(_inv_cell(radius), dtype=torch.float32)
    d2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
          + rel[..., 2] * rel[..., 2])
    ax = torch.clamp_max(torch.floor((rel + r) * inv), 2.0)
    code = (ax[..., 0] * 3.0 + ax[..., 1]) * 3.0 + ax[..., 2]
    return code, (d2 <= r * r) & (code >= 0) & (code < N_CELLS)


def _cell_sums_plain(ctr, pts, feats, radius, tile_ptr, tile_idx):
    """The forward's walk: f32 cell sums (B, Ncp, 27, Cin) and counts
    (B, Ncp, 27), one center tile at a time over the candidates of its
    listed tiles (memory bounded by one tile's pairs).  ``feats=None``:
    counts only, sums None."""
    B, Ncp, _ = ctr.shape
    Mp = pts.shape[1]
    cin = 0 if feats is None else feats.shape[2]
    dev = ctr.device
    x = None if feats is None else feats.float()
    sums = None if feats is None else torch.zeros(
        (B, Ncp, N_CELLS, cin), dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, Ncp, N_CELLS), dtype=torch.float32, device=dev)
    lane = torch.arange(TILE, device=dev)
    for b, row, tiles in _walk(tile_ptr, tile_idx, B, Ncp // TILE,
                               Mp // TILE, dev):
        cidx = (tiles[:, None] * TILE + lane[None, :]).reshape(-1)
        c = ctr[b, row * TILE:(row + 1) * TILE]            # (TILE, 3)
        code, ok = _pair_codes(pts[b, cidx][None, :, :] - c[:, None, :],
                               radius)                     # (TILE, n)
        ii, jj = torch.nonzero(ok, as_tuple=True)
        slot = ii * N_CELLS + code[ii, jj].long()
        if sums is not None:
            s = sums[b, row * TILE:(row + 1) * TILE].view(-1, cin)
            s.index_add_(0, slot, x[b, cidx[jj]])
        cnt[b, row * TILE:(row + 1) * TILE].view(-1).index_add_(
            0, slot, torch.ones_like(slot, dtype=torch.float32))
    return sums, cnt


def conv_fwd_means_plain(ctr, pts, feats, radius: float, tile_ptr=None,
                         tile_idx=None, cnt_in=None):
    """Plain PyTorch version of ``conv_fwd_means``: f32 cell sums and
    counts, the sums divided in f32 by max(cnt, 1) (or max(cnt_in, 1)) and
    rounded to the features' type; (xbar (B*Ncp, 27*Cin), cnt)."""
    B, Ncp, _, cin = _check_means(ctr, pts, feats, tile_ptr, tile_idx,
                                  cnt_in)
    sums, cnt = _cell_sums_plain(ctr, pts, feats, radius, tile_ptr, tile_idx)
    div = cnt if cnt_in is None else cnt_in
    xbar = (sums / torch.clamp_min(div, 1.0)[..., None]).to(feats.dtype)
    return xbar.reshape(B * Ncp, N_CELLS * cin), cnt


def conv_fwd_product_plain(xbar, w, bias):
    """Plain PyTorch version of ``conv_fwd_product``: the f32 product of
    xbar and W, then the f32 bias."""
    cin, cout = w.shape[1], w.shape[2]
    return xbar.float() @ w.float().reshape(N_CELLS * cin, cout) + bias


def conv_fwd_plain(ctr, pts, feats, w, bias, radius: float, tile_ptr=None,
                   tile_idx=None, cnt_in=None):
    """Plain PyTorch version of ``conv_fwd``: the same padded inputs, the
    same tile list and the same rounding points (features in the matmul
    type, f32 cell sums and counts, means divided in f32 by the counts or
    by ``cnt_in`` and rounded to the matmul type, f32 product, f32
    bias)."""
    B, Ncp, _, _, cout = _check(ctr, pts, feats, w, bias, tile_ptr,
                                tile_idx, cnt_in)
    xbar, cnt = conv_fwd_means_plain(ctr, pts, feats, radius, tile_ptr,
                                     tile_idx, cnt_in)
    return conv_fwd_product_plain(xbar, w, bias).view(B, Ncp, cout), cnt


def conv_counts_plain(ctr, pts, radius: float, tile_ptr=None,
                      tile_idx=None):
    """Plain PyTorch version of ``conv_counts``: the forward's walk and cell
    codes with no features; the counts of ``conv_fwd_plain``."""
    _check_walk(ctr, pts, tile_ptr, tile_idx)
    return _cell_sums_plain(ctr, pts, None, radius, tile_ptr, tile_idx)[1]


def conv_dw_means_plain(ctr, pts, feats, cnt, radius: float, tile_ptr=None,
                        tile_idx=None):
    """Plain PyTorch version of ``conv_dw_means``: the forward's cell sums
    divided in f32 by max(cnt, 1) and rounded to the features' type."""
    return conv_fwd_means_plain(ctr, pts, feats, radius, tile_ptr, tile_idx,
                                cnt_in=cnt)[0]


def conv_dw_product_plain(xbar, g):
    """Plain PyTorch version of ``conv_dw_product``: g rounded to xbar's
    type, the f32 product of xbar^T and it."""
    cin, cout = _check_dw_product(xbar, g)
    dw = xbar.float().T @ g.to(xbar.dtype).float()
    return dw.reshape(N_CELLS, cin, cout)


def conv_dw_plain(ctr, pts, feats, g, cnt, radius: float, tile_ptr=None,
                  tile_idx=None):
    """Plain PyTorch version of ``conv_dw``: the forward's cell sums divided
    by the forward's counts and rounded to the matmul type, g rounded to the
    matmul type, and their f32 product over all centers."""
    B, Ncp, _, _, cout = _check_dw(ctr, pts, feats, g, cnt, tile_ptr,
                                   tile_idx)
    xbar = conv_dw_means_plain(ctr, pts, feats, cnt, radius, tile_ptr,
                               tile_idx)
    return conv_dw_product_plain(xbar, g.reshape(B * Ncp, cout))


def _dx_sums_plain(ctr, pts, g, cnt, radius, tile_ptr, tile_idx, dtype):
    """dX's per-cell sums in f32, (B, Mp, 27, Cout): for each candidate
    tile, the centers of its listed center tiles; Z[j, k] sums
    round(1/max(cnt, 1)) * round(g_i) over the in-ball centers i of cell k
    (codes from candidate - center, as the forward's)."""
    B, Mp = pts.shape[:2]
    Ncp, cout = g.shape[1], g.shape[2]
    dev = ctr.device
    gm = g.to(dtype).float()
    inv_cnt = (1.0 / torch.clamp_min(cnt, 1.0)).to(dtype).float()
    z = torch.zeros((B, Mp, N_CELLS, cout), dtype=torch.float32, device=dev)
    lane = torch.arange(TILE, device=dev)
    for b, row, tiles in _walk(tile_ptr, tile_idx, B, Mp // TILE,
                               Ncp // TILE, dev):
        cidx = (tiles[:, None] * TILE + lane[None, :]).reshape(-1)
        q = pts[b, row * TILE:(row + 1) * TILE]            # (TILE, 3)
        code, ok = _pair_codes(q[:, None, :] - ctr[b, cidx][None, :, :],
                               radius)                     # (TILE, n)
        ii, jj = torch.nonzero(ok, as_tuple=True)
        k = code[ii, jj].long()
        ci = cidx[jj]
        zt = z[b, row * TILE:(row + 1) * TILE].view(-1, cout)
        zt.index_add_(0, ii * N_CELLS + k,
                      inv_cnt[b, ci, k][:, None] * gm[b, ci])
    return z


def conv_dx_sums_plain(ctr, pts, g, cnt, radius: float, tile_ptr=None,
                       tile_idx=None, dtype=torch.float32):
    """Plain PyTorch version of ``conv_dx_sums``: the f32 sums rounded to
    ``dtype``, (B*Mp, 27*Cout)."""
    B, _, Mp, cout = _check_dx_sums(ctr, pts, g, cnt, tile_ptr, tile_idx,
                                    dtype)
    z = _dx_sums_plain(ctr, pts, g, cnt, radius, tile_ptr, tile_idx, dtype)
    return z.to(dtype).reshape(B * Mp, N_CELLS * cout)


def conv_dx_product_plain(z, w):
    """Plain PyTorch version of ``conv_dx_product``: the forward's plain
    product with W transposed per cell and a zero bias."""
    return conv_fwd_product_plain(
        z, w.transpose(1, 2),
        torch.zeros(w.shape[1], dtype=torch.float32, device=w.device))


def conv_dx_plain(ctr, pts, g, cnt, w, radius: float, tile_ptr=None,
                  tile_idx=None):
    """Plain PyTorch version of ``conv_dx``: ``conv_dx_sums_plain`` in W's
    type (g, 1/max(cnt, 1) and Z rounded to it), then round(Z) . W^T in
    f32."""
    B, _, Mp, cin, _ = _check_dx(ctr, pts, g, cnt, w, tile_ptr, tile_idx)
    z = conv_dx_sums_plain(ctr, pts, g, cnt, radius, tile_ptr, tile_idx,
                           w.dtype)
    return conv_dx_product_plain(z, w).view(B, Mp, cin)


# ---- tile-bbox adjacency (plain tensor code, not a kernel) ---------------


def _row_tile_boxes(pts, tile: int):
    """Sentinel-aware per-tile bboxes of (B, N, 3) points; (B, n, 3) lo/hi.
    (Serves both sides: the port keeps candidates in the same (B, M, 3)
    layout as centers, where the TPU kernels wanted them transposed.)"""
    B, N, _ = pts.shape
    t = pts.reshape(B, N // tile, tile, 3)
    v = torch.abs(t) < _SENTINEL_CUT
    count_sync("tile_boxes")      # a scalar copied from pageable memory
    big = torch.tensor(1.0e9, dtype=torch.float32, device=pts.device)
    return (torch.where(v, t, big).amin(dim=2),
            torch.where(v, t, -big).amax(dim=2))


def _boxes_adjacency(radius: float, lo_r, hi_r, lo_c, hi_c,
                     rows_per_chunk: int = 512):
    """Per-row-tile lists of bbox-adjacent column tiles, as compact CSR.

    Returns tile_ptr (B*nR + 1,) int32, the offsets, and tile_idx (nnz,)
    int32: row tile (b, r) lists tile_idx[tile_ptr[b*nR + r] :
    tile_ptr[b*nR + r + 1]], its adjacent column tiles in ascending order.
    The list has no length cap.  A conservative test (bbox gap with a small
    slack): every in-ball pair lies in an adjacent tile pair.  The bbox gaps
    are taken ``rows_per_chunk`` row tiles at a time, so only the boolean
    (B, nR, nC) adjacency is held whole."""
    B, nR, _ = lo_r.shape
    nC = lo_c.shape[1]
    thresh = float(np.float32(np.float32(radius * radius) * np.float32(1.0001)
                              + np.float32(1e-9)))
    adj = torch.empty((B, nR, nC), dtype=torch.bool, device=lo_r.device)
    for r0 in range(0, nR, rows_per_chunk):
        rows = slice(r0, r0 + rows_per_chunk)
        d2 = None
        for a in range(3):         # x, y, z summed in that order
            gap = torch.clamp_min(torch.maximum(
                lo_r[:, rows, None, a] - hi_c[:, None, :, a],
                lo_c[:, None, :, a] - hi_r[:, rows, None, a]), 0.0)
            d2 = gap * gap if d2 is None else d2 + gap * gap
        adj[:, rows] = d2 <= thresh
    if B * nR * nC > np.iinfo(np.int32).max:
        raise ValueError(f"{B}x{nR}x{nC} tile pairs overflow int32 offsets")
    tile_ptr = torch.zeros(B * nR + 1, dtype=torch.int32, device=adj.device)
    tile_ptr[1:] = torch.cumsum(adj.sum(dim=-1).reshape(-1), 0)
    count_sync("tile_lists")      # nonzero's length is read on the host
    tile_idx = (torch.nonzero(adj.reshape(-1))[:, 0] % nC).to(torch.int32)
    return tile_ptr, tile_idx.contiguous()


def tile_adjacency(ctr, pts, radius: float):
    """Center-tile -> candidate-tile lists (tile_ptr, tile_idx) for the CSR
    walk of ``conv_fwd``, ``conv_dw`` and ``conv_counts``.  The bbox test is symmetric, so
    ``tile_adjacency(pts, ctr, radius)`` is the transposed list (candidate
    tile -> center tiles) that ``conv_dx`` walks."""
    lo_r, hi_r = _row_tile_boxes(ctr, TILE)
    lo_c, hi_c = _row_tile_boxes(pts, TILE)
    return _boxes_adjacency(radius, lo_r, hi_r, lo_c, hi_c)


# ---- the walk's cull, as the kernel decides it (plain tensor code) -------


def walk_boxes(p, n: int = WALK_K):
    """Boxes (lo, hi), each (B, N/n, 3) f32, of every ``n`` consecutive
    points of (B, N, 3), as the walk forms them: a point with any
    coordinate at |x| >= ``_SENTINEL_CUT`` (padding) is left out, and a box
    of padding alone is empty (lo 1e9 > hi -1e9).  No host sync."""
    B, N, _ = p.shape
    t = p.reshape(B, N // n, n, 3)
    real = (t.abs() < _SENTINEL_CUT).all(dim=-1, keepdim=True)
    return (torch.where(real, t, _BOX_EMPTY).amin(dim=2),
            torch.where(real, t, -_BOX_EMPTY).amax(dim=2))


def walk_keeps(row_lo, row_hi, grp_lo, grp_hi, radius: float):
    """Whether the walk keeps a k-step: the squared gap of a group's box
    (grp_lo, grp_hi) to the box of a CTA's rows (row_lo, row_hi), each
    axis max(grp_lo - row_hi, row_lo - grp_hi, 0) rounded in f32 and the
    squares summed in x, y, z order, is at most r*r rounded in f32.  Any
    (..., 3) shapes that broadcast.  Rounding is monotone, so this gap is
    at most ``pair_code``'s d2 of any pair of the two boxes: a dropped
    group holds no in-ball pair of those rows."""
    d2 = None
    for a in range(3):
        gap = torch.clamp_min(torch.maximum(grp_lo[..., a] - row_hi[..., a],
                                            row_lo[..., a] - grp_hi[..., a]),
                              0.0)
        d2 = gap * gap if d2 is None else d2 + gap * gap
    r = np.float32(radius)
    return d2 <= float(r * r)


def walk_cull_counts(ctr, pts, radius: float, tile_ptr=None, tile_idx=None):
    """(kept, listed): the k-steps of ``WALK_K`` candidates that the walks'
    CTAs keep and that their lists hold, summed over every block of
    ``WALK_M`` rows (once per row block, whatever the CTAs of a block).
    ``ctr`` are the walk's rows and ``pts`` its columns (for dX: the
    candidates and the centers, with the transposed list)."""
    B, Ncp, Mp = _check_walk(ctr, pts, tile_ptr, tile_idx)
    r_lo, r_hi = walk_boxes(ctr, WALK_M)
    g_lo, g_hi = walk_boxes(pts, WALK_K)
    n_rows, n_cols = Ncp // TILE, Mp // TILE
    dev = ctr.device
    if tile_ptr is None:
        entries = torch.arange(B * n_rows * n_cols, device=dev)
        row, col = entries // n_cols, entries % n_cols
    else:
        row = torch.repeat_interleave(
            torch.arange(B * n_rows, device=dev),
            (tile_ptr[1:] - tile_ptr[:-1]).long())
        col = tile_idx.long()
    b, row = row // n_rows, row % n_rows
    per = TILE // WALK_K
    sub = torch.arange(per, device=dev)
    kept, chunk = 0, 1 << 16           # list entries tested at a time
    for e0 in range(0, row.numel(), chunk):
        bb = b[e0:e0 + chunk, None, None]
        rr = (row[e0:e0 + chunk, None] * (TILE // WALK_M)
              + torch.arange(TILE // WALK_M, device=dev))[:, :, None]
        gg = (col[e0:e0 + chunk, None] * per + sub)[:, None, :]
        kept += int(walk_keeps(r_lo[bb, rr], r_hi[bb, rr], g_lo[bb, gg],
                               g_hi[bb, gg], radius).sum())
    return kept, row.numel() * (TILE // WALK_M) * per


def walk_cull_share(ctr, pts, radius: float, tile_ptr=None, tile_idx=None):
    """The share of the listed k-steps that the walks' CTAs keep, as the
    kernel decides it (``walk_cull_counts``; 1.0 for an empty list).  Off
    the main path: the tools and tests read it."""
    kept, listed = walk_cull_counts(ctr, pts, radius, tile_ptr, tile_idx)
    return kept / listed if listed else 1.0
