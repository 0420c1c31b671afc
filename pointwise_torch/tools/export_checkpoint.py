"""Export the weights of a JAX trainer checkpoint to an ``.npz``.

    python -m pointwise_torch.tools.export_checkpoint runs/seg weights.npz
    python -m pointwise_torch.tools.export_checkpoint runs/seg w.npz \
        --step 2000

Reads the newest committed orbax step of ``train.py --checkpoint-dir`` (or
``--step``) with ``convert.read_jax_checkpoint`` and writes its parameters
and BatchNorm running averages as the flat arrays that ``--params`` of
``python -m pointwise_torch.infer`` and ``pointwise_torch.eval`` reads
("params/..." and "batch_stats/..." keys).  It needs ``tensorstore``, so it
runs wherever the JAX trainer ran; the ``.npz`` then serves on a machine
without it.  It touches no device.  Prints one JSON record: the step, the
output path and the number of arrays.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from pointwise_torch.convert import read_jax_checkpoint


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.export_checkpoint")
    ap.add_argument("checkpoint_dir",
                    help="a JAX trainer run's --checkpoint-dir")
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--step", type=int, default=None,
                    help="a committed step (default: the newest)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the printed record."""
    args = parse_args(argv)
    step, variables = read_jax_checkpoint(args.checkpoint_dir, args.step)
    with open(args.out, "wb") as f:
        np.savez(f, **variables)
    rec = {"step": step, "out": args.out, "arrays": len(variables)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
