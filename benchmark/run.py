"""Run one cell of BENCHMARK.json once, on the card:

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root.  With ``--trace 0`` the last line of standard
output holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (the same window, then a few requests or steps under
the profiler) and a breakdown.  Every run checks what the timed path
produced against the plain reference (benchmark/reference/) and prints
each compared number beside its limit, last on standard error and last in
the line.  Without a card the run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
# whole top-level module names that no run may have loaded
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "pointwise_tpu", "bench")
FORBIDDEN_MODULES = ("pointwise_torch.bench",)


def forbidden_modules(names) -> list:
    """The loaded modules of JAX, the JAX package or the JAX bench,
    compared by whole top-level name."""
    return sorted(m for m in names
                  if m.split(".")[0] in FORBIDDEN_TOP
                  or m in FORBIDDEN_MODULES
                  or any(m.startswith(f + ".") for f in FORBIDDEN_MODULES))


def _fixed_caches() -> None:
    """Kernel caches of libraries that build at run time, at fixed paths
    inside the checkout (the program's own kernels build into
    pointwise_torch/kernels/_build/ and pointwise_torch/native/_build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)


def _power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return (out.stdout.strip().splitlines() or ["not read"])[0]


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: float | None = None,
            bench: dict | None = None, log=None, config_update=None,
            traffic_update=None) -> dict:
    """Run ``workload`` once on ``device`` and return the result line's
    object.  Tests call this on the CPU, with ``config_update`` and
    ``traffic_update`` shrinking the cell; the command refuses to."""
    import torch

    from benchmark import cell, devtrace, traffic
    from benchmark.check import correct
    from benchmark.metrics import reader

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = bench or cell.load_benchmark()
    c, centry = cell.find(bench, workload)
    cfg = dict(cell.load_json(cell.ROOT, centry["file"]),
               **(config_update or {}))
    mix = dict(traffic.load(c["traffic"]), **(traffic_update or {}))
    loop = importlib.import_module(f"benchmark.{mix['kind']}")
    rec = loop.run(cfg, mix, seed, seconds, trace, device,
                     T_START if t_start is None else t_start,
                     cell.load_limits(workload), log)
    metrics = {}
    for m in cell.metrics_for(bench, workload, trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    out = {"correct": correct(rec["checks"]) and rec["failed"] == 0,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": rec["memory_peak_bytes"]}}
    if trace:
        t = rec["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": devtrace.top(t["ops"]),
                            "idle_gaps": devtrace.top(t["gaps"])}
    out["checks"] = rec["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    from benchmark import cell

    bench = cell.load_benchmark()
    c, _ = cell.find(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"benchmark: the cell needs {c['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import pointwise_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e!r}",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", bench=bench)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"# card: {_power_line()}", file=sys.stderr)
    for name, chk in out["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
