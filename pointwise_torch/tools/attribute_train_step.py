"""Device time of a training step by operation.

    python -m pointwise_torch.tools.attribute_train_step --config seg
    python -m pointwise_torch.tools.attribute_train_step --config cls
    python -m pointwise_torch.tools.attribute_train_step --config cls_tiny \
        --steps 2 --device cpu

A port of scripts/attribute_train_step.py.  The step is the train CLI's
(its model, loss, optimizer and trainer) on one training batch, used for
every step: ``--config cls`` is modelnet40_synthetic's classifier at 32 x
1024, ``seg`` s3dis_synthetic's segmenter at 8 x 4096 (global context, the
JAX bench's segmentation step); any other configuration name of the
registry works too, and ``--batch`` / ``--points`` resize it.  One warm-up
step, then ``--steps`` steps back to back with one sync at each end of the
window (the untraced ms per step), then ``--steps`` steps under
torch.profiler (``runtime.StepWindow``).  Prints one JSON record: ms per
untraced step, device ms per step (the union of the card's busy
intervals), the host share 1 - device / untraced ms, the total of the
device ops (at most the device ms when no two ops overlap; the gap to the
untraced step is host time and bubbles), the ``--top`` ops by name and the
rollup by kernel family.  Without device time (the CPU) those say "not
measured".
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from pointwise_torch import resolve_device
from pointwise_torch.data import modelnet, pipeline, s3dis, scenenn
from pointwise_torch.train import cli, get_config
from pointwise_torch.train.configs import ClassificationConfig
from pointwise_torch.train.trainer import Trainer
from pointwise_torch.utils.runtime import StepWindow

ALIASES = {"cls": "modelnet40_synthetic", "seg": "s3dis_synthetic"}


def first_batch(cfg):
    """(``cfg``, the train CLI's first training batch of it, numpy); a
    classification head is widened to the data's classes as the CLI does."""
    if isinstance(cfg, ClassificationConfig):
        data = modelnet.load_modelnet40(cfg.data_dir, "train",
                                        cfg.num_points, seed=cfg.seed,
                                        variant=cfg.variant)
        cfg = dataclasses.replace(
            cfg, num_classes=max(cfg.num_classes, data.num_classes))
        return cfg, next(modelnet.batches(data, cfg.batch_size,
                                          seed=cfg.seed))
    if cfg.name.startswith("shapenetpart"):
        raise ValueError("attribute_train_step takes classification and "
                         "semantic segmentation configs")
    load = (scenenn.load_scenes if cfg.name.startswith("scenenn")
            else s3dis.load_rooms)
    blocks = s3dis.training_blocks(cfg, rooms=load(cfg.data_dir,
                                                   seed=cfg.seed))
    return cfg, next(s3dis.block_batches(blocks, cfg.batch_size,
                                         seed=cfg.seed))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pointwise_torch.tools.attribute_train_step")
    ap.add_argument("--config", default="cls",
                    help="cls, seg or a configuration name")
    ap.add_argument("--steps", type=int, default=8,
                    help="untraced steps, then as many traced")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the printed record."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.config, args.config))
    resize = {k: v for k, v in (("batch_size", args.batch),
                                ("num_points", args.points)) if v}
    cfg, batch = first_batch(dataclasses.replace(cfg, **resize))
    if isinstance(cfg, ClassificationConfig):
        model, loss_fn = cli.build_classifier(cfg, dev)
    else:
        model, loss_fn = cli.build_segmenter(cfg, dev)
    trainer = Trainer(model, loss_fn, cfg.optimizer)
    batch = pipeline.to_device(batch, dev)
    n = max(1, args.steps)
    window = StepWindow(dev, first=1, last=1 + n, end=1 + 2 * n)
    for step in range(1, 2 + 2 * n):
        trainer.step(batch, seed=1)
        window(step)
    rec = dict(config=cfg.name, batch=cfg.batch_size, points=cfg.num_points,
               device=str(dev), **window.summary(top=args.top))
    if isinstance(rec["device_ms_per_step"], float):
        rec["host_share"] = rec.pop("device_idle_share")
    rec["trained_points_per_s"] = (cfg.batch_size * cfg.num_points
                                   / rec["ms_per_step"] * 1e3)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
