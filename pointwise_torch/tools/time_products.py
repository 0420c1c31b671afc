"""The forward's and dX's product kernels alone, timed against cuBLAS.

    python -m pointwise_torch.tools.time_products
        [--shape fwd:229376:124:124 --shape dx:32768:124:124 ...]
    python -m pointwise_torch.tools.time_products --device cpu \
        --shape fwd:128:6:5

Each ``--shape`` is ``kind:rows:cin:cout``: ``fwd`` times
``conv_fwd_product`` (y = xbar . W + bias, K = 27 * cin, N = cout), ``dx``
times ``conv_dx_product`` (dx = Z . W^T per cell, K = 27 * cout, N = cin).
The defaults are the main path's shapes: the forward's product at layer 1
of the 1M-point request (229,376 centers, 124 -> 124) and of the first
layer (6 -> 124), dX's at a segmentation step's 8 x 4096 candidates (124
-> 124) and the bench's 64-wide conv (64 x 1024 rows, 64 -> 64).  The A
operand is random bf16 made on the device from seed 0 with the
workspace's row stride, round_up(K, 8), and NaN in the columns past K,
which the kernels never read; W and the bias come from the same seed.

For each shape, one JSON record: the kernel's card ms and one PyTorch
(cuBLAS) call of the same function (``library_ms``; the port never calls
it), each from CUDA events over ``REPS`` calls after one warm-up, timed
in turns (kernel, library, library, kernel; each ms the mean of its two
turns); the bound (each input read once and y written once over 3.35
TB/s, or 2 * rows * K * N operations over 989 TFLOP/s bf16, the larger);
and the kernel's max error against the library's result, relative to its
max |y|, which must stay under 1e-4 (only the order of the f32 sums
differs).  Any failure raises.  On the CPU (``--device cpu``) the plain
versions run and every ms is "not measured".
"""

from __future__ import annotations

import argparse
import json

import torch

from pointwise_torch import resolve_device
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.utils.runtime import NOT_MEASURED, event_ms

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # bf16 tensor cores, dense
DEFAULT_SHAPES = ("fwd:229376:124:124", "fwd:229376:6:124",
                  "dx:32768:124:124", "dx:65536:64:64")
MAX_REL_ERR = 1e-4
REPS = 20


def parse_shape(text: str) -> tuple:
    """``kind:rows:cin:cout`` -> (kind, rows, cin, cout); rows a multiple
    of the row tile."""
    kind, *nums = text.split(":")
    if kind not in ("fwd", "dx") or len(nums) != 3:
        raise ValueError(f"shape {text!r} is not fwd|dx:rows:cin:cout")
    rows, cin, cout = (int(v) for v in nums)
    if rows <= 0 or rows % tk.TILE or cin <= 0 or cout <= 0:
        raise ValueError(f"shape {text!r}: rows a positive multiple of "
                         f"{tk.TILE}, widths positive")
    return kind, rows, cin, cout


def operands(kind, rows, cin, cout, dev):
    """(A (rows, K) bf16, a view of a workspace whose columns past K hold
    NaN; W (27, cin, cout) bf16; the bias (cout,) f32 or None)."""
    g = torch.Generator(device=dev).manual_seed(0)
    k = 27 * (cin if kind == "fwd" else cout)
    ws = torch.full((rows, tk.round_up(k, 8)), float("nan"),
                    dtype=torch.bfloat16, device=dev)
    ws[:, :k] = torch.randn((rows, k), generator=g, device=dev)
    w = (torch.randn((27, cin, cout), generator=g, device=dev)
         / k ** 0.5).bfloat16()
    bias = (0.1 * torch.randn((cout,), generator=g, device=dev)
            if kind == "fwd" else None)
    return ws[:, :k], w, bias


def library_call(a, wk, bias):
    """One cuBLAS call of a . wk (+ bias) with bf16 operands and an f32
    result: (a call with no arguments, its name)."""
    try:
        if bias is None:
            torch.mm(a[:64], wk, out_dtype=torch.float32)
            return (lambda: torch.mm(a, wk, out_dtype=torch.float32)), \
                "mm(out_dtype=float32)"
        torch.addmm(bias, a[:64], wk, out_dtype=torch.float32)
        return (lambda: torch.addmm(bias, a, wk, out_dtype=torch.float32)), \
            "addmm(out_dtype=float32)"
    except (RuntimeError, TypeError):
        # this torch's mm takes no out_dtype: the same function in f32
        af, wf = a.float(), wk.float()
        if bias is None:
            return (lambda: torch.mm(af, wf)), "mm of the operands in float32"
        return ((lambda: torch.addmm(bias, af, wf)),
                "addmm of the operands in float32")


def time_shape(kind, rows, cin, cout, dev) -> dict:
    a, w, bias = operands(kind, rows, cin, cout, dev)
    k, n = a.shape[1], (cout if kind == "fwd" else cin)
    if kind == "fwd":
        wk = w.reshape(k, n)
        run = lambda: tk.conv_fwd_product(a, w, bias)     # noqa: E731
    else:
        wk = w.transpose(1, 2).reshape(k, n)
        run = lambda: tk.conv_dx_product(a, w)            # noqa: E731
    lib, lib_name = library_call(a, wk, bias)
    y, want = run(), lib()
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{kind} product of {rows} x {k} x {n}: "
                             f"non-finite output")
    err = float((y - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if err > MAX_REL_ERR:
        raise AssertionError(f"{kind} product of {rows} x {k} x {n} is "
                             f"{err:.3g} off the library's (> {MAX_REL_ERR})")
    nbytes = rows * k * 2 + k * n * 2 + rows * n * 4 + (
        n * 4 if bias is not None else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * rows * k * n / BF16_FLOPS
    rec = dict(kind=kind, rows=rows, k=k, n=n, library_call=lib_name,
               bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_rel_err=err)
    if dev.type != "cuda":
        return dict(rec, ms=NOT_MEASURED, library_ms=NOT_MEASURED)
    turns = [event_ms(run, REPS), event_ms(lib, REPS), event_ms(lib, REPS),
             event_ms(run, REPS)]
    return dict(rec, ms=(turns[0] + turns[3]) / 2,
                library_ms=(turns[1] + turns[2]) / 2, turns_ms=turns)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.time_products")
    ap.add_argument("--shape", action="append", default=None,
                    help="kind:rows:cin:cout, repeatable (default: the main "
                         "path's shapes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Time every shape; returns the printed records."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    shapes = [parse_shape(s) for s in (args.shape or DEFAULT_SHAPES)]
    recs = []
    for kind, rows, cin, cout in shapes:
        rec = time_shape(kind, rows, cin, cout, dev)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
