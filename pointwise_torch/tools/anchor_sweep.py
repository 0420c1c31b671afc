"""The seed-averaged anchor protocol: train, then evaluate, per seed.

    python -m pointwise_torch.tools.anchor_sweep --config cls_synthetic_hard \
        --steps 1000 --votes 12
    python -m pointwise_torch.tools.anchor_sweep --config shapenetpart_hard \
        --steps 1200
    python -m pointwise_torch.tools.anchor_sweep --config cls_tiny --steps 2 \
        --seeds 0 1 --votes 2 --device cpu

A port of scripts/anchor_sweep.py.  Per seed (default 0, 1, 2: the
training draw and the init vary, the eval set stays the config's) it runs
``python -m pointwise_torch.train --seed S`` into a temporary checkpoint
directory and then ``python -m pointwise_torch.eval`` on it, each in its
own process, and prints the eval's JSON record per seed and, last, one
JSON record with the mean, min and per-seed values of every metric all
seeds report.  GOLDEN.md pins the JAX package's 3-seed means and mins; the
port's seeds draw other numbers than ``jax.random``, so its mean is what
compares.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(cmd):
    out = subprocess.run([sys.executable, "-m", *cmd], capture_output=True,
                         text=True, cwd=REPO)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:1])} failed:\n"
                           + out.stderr[-2000:])
    return out.stdout


def run_one(config: str, seed: int, steps: int | None, votes: int | None,
            device: str) -> dict:
    """The eval record of one seed's trained checkpoint."""
    with tempfile.TemporaryDirectory(prefix=f"anchor_{config}_{seed}_") as d:
        cmd = ["pointwise_torch.train", "--config", config, "--seed",
               str(seed), "--checkpoint-dir", d, "--device", device]
        if steps:
            cmd += ["--steps", str(steps)]
        _run(cmd)
        cmd = ["pointwise_torch.eval", "--config", config,
               "--checkpoint-dir", d, "--device", device]
        if votes:
            cmd += ["--votes", str(votes)]
        recs = [json.loads(ln) for ln in _run(cmd).splitlines()
                if ln.startswith("{")]
        return recs[-1]


def summarize(config: str, seeds, rows) -> dict:
    """Mean, min and per-seed values of every numeric metric all rows
    share."""
    keys = [k for k, v in rows[0].items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and k not in ("seed", "n", "scenes")
            and all(isinstance(r.get(k), (int, float)) for r in rows)]
    out = {"config": config, "seeds": list(seeds)}
    for k in keys:
        vals = [float(r[k]) for r in rows]
        out[f"{k}_mean"] = sum(vals) / len(vals)
        out[f"{k}_min"] = min(vals)
        out[f"{k}_per_seed"] = vals
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.anchor_sweep")
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--votes", type=int, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the train CLI raises without a "
                         "card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the protocol; returns the summary record."""
    args = parse_args(argv)
    rows = []
    for seed in args.seeds:
        rec = dict(run_one(args.config, seed, args.steps, args.votes,
                           args.device), seed=seed)
        rows.append(rec)
        print(f"# seed {seed}: {json.dumps(rec)}", flush=True)
    summary = summarize(args.config, args.seeds, rows)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
