"""The readings that the limits of ``correct`` are set from, for the loop
that ``benchmark/calibrate.py`` does not know (``vote``; not run by the
benchmark's own runs):

  python3 -m benchmark.calibrate_loops --workload <cell> --seeds 1 2 ... [--faults 2]

For each seed, in one process on the card: the program's readings (a run
of the cell whose window holds the two rooms it checks), the precision
control's (the reference computed in fp8 in the program's place, against
the reference, on a room of that seed) and, for the first ``--faults``
seeds, the readings of the program with each fault planted: one point's
votes moved and one chunk left out of the votes.  One JSON line per seed
and reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import cell, traffic


def main(argv=None) -> int:
    from benchmark import run, vote

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_loops")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=2)
    ap.add_argument("--controls", type=int, default=None,
                    help="seeds that also read the control (default all)")
    args = ap.parse_args(argv)
    run._fixed_caches()
    if not torch.cuda.is_available():
        print("calibrate_loops: no CUDA device", file=sys.stderr)
        return 2
    c, centry = cell.find(cell.load_benchmark(), args.workload)
    mix = traffic.load(c["traffic"])
    if mix["kind"] == "vote":
        seconds, faults = 0.0, (vote.vote_moved, vote.chunk_left_out)
        control = vote.control_readings
    else:
        print(f"calibrate_loops: the {mix['kind']!r} loop is "
              f"benchmark/calibrate.py's", file=sys.stderr)
        return 2

    def emit(seed, what, checks):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": what,
                          "values": {k: (v["value"] if isinstance(v, dict)
                                         else v)
                                     for k, v in checks.items()}}),
              flush=True)

    for i, seed in enumerate(args.seeds):
        out = run.execute(args.workload, seed, seconds, False, "cuda")
        emit(seed, "program", out["checks"])
        if args.controls is None or i < args.controls:
            emit(seed, "fp8", control(args.workload, seed))
        for fault in faults if i < args.faults else ():
            with fault():
                out = run.execute(args.workload, seed, seconds, False, "cuda")
            emit(seed, fault.__name__, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
