"""Training CLI: ``python -m pointwise_torch.train``.

A port of train.py (segmentation and classification; one device):

  python -m pointwise_torch.train --config s3dis_synthetic_local --steps 20
  python -m pointwise_torch.train --config modelnet40_synthetic --steps 20
  python -m pointwise_torch.train --config seg_tiny_local --steps 3 --device cpu

The convs run in the Hopper kernels on the card (forward, and dW / dX in
the backward); ``--device cpu`` runs their plain PyTorch versions.  Every
step prints nothing but the metric lines (JSONL) of ``log_every`` steps,
the first step and each evaluation.

Resumable: the randomness of step ``s`` derives from (seed, s) and the data
epoch and offset from ``s``, so ``--resume`` from a checkpoint replays the
uninterrupted run exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import torch

from pointwise_torch import resolve_device
from pointwise_torch.data import augment, modelnet, pipeline, s3dis
from pointwise_torch.models import (
    PointwiseClassifier,
    PointwiseSegmenter,
    classification_loss,
    segmentation_loss,
)
from pointwise_torch.train.configs import ClassificationConfig, get_config
from pointwise_torch.train.trainer import Trainer, log_metrics, step_seed

# the eval seeds sit far from the step seeds (the JAX loop's 1 << 30 offset)
_EVAL_KEY = 1 << 30


def run_train_loop(trainer: Trainer, cfg, args, *, make_epoch_iter,
                   steps_per_epoch: int, max_steps: int, eval_iter=None,
                   eval_split: str = "test", on_step=None) -> Trainer:
    """Deterministic, resumable training loop.

    Step ``s`` runs on seed ``step_seed(seed, s)`` and on batch
    ``s % steps_per_epoch`` of epoch ``s // steps_per_epoch``; checkpoints
    carry the seed.  ``on_step(step, metrics)`` runs after every step."""
    seed = cfg.seed
    if args.resume and cfg.checkpoint_dir:
        start = trainer.restore_checkpoint(cfg.checkpoint_dir)
        if trainer.restored_extra is not None:
            seed = int(trainer.restored_extra["seed"])
        print(f"# resumed at step {start}", flush=True)
    extra = {"seed": seed}
    device = trainer.device

    t0 = time.time()
    step = trainer.step_count
    while step < max_steps:
        it = make_epoch_iter(step // steps_per_epoch)
        skip = step % steps_per_epoch
        if skip:
            it = itertools.islice(it, skip, None)
        step_at_entry = step
        for batch in pipeline.prefetch_to_device(it, device):
            metrics = trainer.step(batch, step_seed(seed, step))
            step += 1
            if on_step is not None:
                on_step(step, metrics)
            if step % cfg.log_every == 0 or step == 1:
                log_metrics(step, metrics, t0=t0)
            if eval_iter is not None and (
                    step % cfg.eval_every == 0 or step == max_steps):
                ev = trainer.evaluate(
                    pipeline.prefetch_to_device(eval_iter(), device),
                    step_seed(seed, _EVAL_KEY + step))
                log_metrics(step, ev, t0=t0, extra={"split": eval_split})
            if cfg.checkpoint_dir and step % cfg.checkpoint_every == 0:
                trainer.save_checkpoint(cfg.checkpoint_dir,
                                        cfg.keep_checkpoints, extra=extra)
            if step >= max_steps:
                break
        if step == step_at_entry:
            raise ValueError(
                "epoch iterator yielded no batches (dataset smaller than "
                f"batch_size after the {skip}-batch resume offset?) — "
                "training cannot make progress")
    if cfg.checkpoint_dir:
        trainer.save_checkpoint(cfg.checkpoint_dir, cfg.keep_checkpoints,
                                extra=extra)
    return trainer


def _init_generator(cfg) -> torch.Generator:
    """Weights are drawn on the CPU from the config seed, then moved: the
    same seed gives the same initial weights on every device."""
    return torch.Generator().manual_seed(cfg.seed)


def build_classifier(cfg: ClassificationConfig, device):
    model = PointwiseClassifier(
        num_classes=cfg.num_classes, channels=cfg.channels, radii=cfg.radii,
        head_dims=cfg.head_dims, dropout_rate=cfg.dropout, norm=cfg.norm,
        impl=cfg.impl, generator=_init_generator(cfg)).to(device)

    def loss_fn(model, batch, generator, train):
        pts = batch["points"]
        if train:
            pts = augment.classification_augment(pts, generator,
                                                 rotate=cfg.rotate_augment)
        loss, acc = classification_loss(model(pts), batch["label"])
        return loss, {"accuracy": acc}

    return model, loss_fn


def build_segmenter(cfg, device):
    model = PointwiseSegmenter(
        num_classes=cfg.num_classes, in_features=cfg.in_features,
        channels=cfg.channels, radii=cfg.radii, head_dims=cfg.head_dims,
        dropout_rate=cfg.dropout, norm=cfg.norm, impl=cfg.impl,
        use_global_context=cfg.global_context,
        generator=_init_generator(cfg)).to(device)

    def loss_fn(model, batch, generator, train):
        pts = batch["points"]
        if train:
            pts = augment.jitter(pts, generator, sigma=0.005, clip=0.02)
        logits = model(pts, batch["features"], batch["mask"])
        loss, acc = segmentation_loss(logits, batch["label"], batch["mask"])
        return loss, {"accuracy": acc}

    return model, loss_fn


def train_classification(cfg: ClassificationConfig, args, device,
                         on_step=None) -> Trainer:
    data_dir = cfg.data_dir or args.data_dir
    train_data = modelnet.load_modelnet40(data_dir, "train", cfg.num_points,
                                          seed=cfg.seed, variant=cfg.variant)
    test_data = modelnet.load_modelnet40(data_dir, "test", cfg.num_points,
                                         synthetic_size=128, seed=cfg.seed,
                                         variant=cfg.variant)
    # a head wide enough for both splits
    ncls = max(train_data.num_classes, test_data.num_classes)
    if ncls != cfg.num_classes:
        cfg = dataclasses.replace(cfg, num_classes=ncls)
    model, loss_fn = build_classifier(cfg, device)
    trainer = Trainer(model, loss_fn, cfg.optimizer)
    steps_per_epoch = max(1, len(train_data.labels) // cfg.batch_size)
    return run_train_loop(
        trainer, cfg, args,
        make_epoch_iter=lambda epoch: modelnet.batches(
            train_data, cfg.batch_size, seed=cfg.seed + epoch),
        steps_per_epoch=steps_per_epoch,
        max_steps=args.steps or cfg.epochs * steps_per_epoch,
        eval_iter=lambda: modelnet.batches(test_data, cfg.batch_size,
                                           shuffle=False,
                                           drop_remainder=False),
        on_step=on_step)


def train_segmentation(cfg, args, device, on_step=None) -> Trainer:
    # heldout ROOMS for the periodic eval: overlapping-stride blocks of one
    # room share points, so a block-level split would leak
    rooms = s3dis.load_rooms(cfg.data_dir or args.data_dir, seed=cfg.seed)
    if len(rooms) >= 2:
        n_eval = max(1, len(rooms) // 10)
        eval_blocks = s3dis.training_blocks(cfg, rooms=rooms[:n_eval])
        blocks = s3dis.training_blocks(cfg, rooms=rooms[n_eval:])
        print(f"# heldout rooms: {n_eval}/{len(rooms)}", flush=True)
    else:
        print("# WARNING: single room — heldout blocks share points with "
              "training blocks", flush=True)
        blocks = s3dis.training_blocks(cfg, rooms=rooms)
        n_eval = max(cfg.batch_size, len(blocks["points"]) // 10)
        eval_blocks = {k: v[:n_eval] for k, v in blocks.items()}
        blocks = {k: v[n_eval:] for k, v in blocks.items()}
    model, loss_fn = build_segmenter(cfg, device)
    trainer = Trainer(model, loss_fn, cfg.optimizer)
    steps_per_epoch = max(1, len(blocks["points"]) // cfg.batch_size)
    return run_train_loop(
        trainer, cfg, args,
        make_epoch_iter=lambda epoch: s3dis.block_batches(
            blocks, cfg.batch_size, seed=cfg.seed + epoch),
        steps_per_epoch=steps_per_epoch,
        max_steps=args.steps or cfg.epochs * steps_per_epoch,
        eval_iter=lambda: s3dis.block_batches(eval_blocks, cfg.batch_size,
                                              shuffle=False,
                                              drop_remainder=False),
        eval_split="heldout_rooms" if len(rooms) >= 2 else "heldout_blocks",
        on_step=on_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pointwise_torch.train")
    ap.add_argument("--config", default="modelnet40_synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="override total steps")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the config seed (init + data + step "
                         "randomness)")
    ap.add_argument("--norm", default=None, choices=["layer", "batch", "none"],
                    help="override the config's normalization ('batch': "
                         "not yet ported)")
    ap.add_argument("--tensorboard", default=None,
                    help="tf.summary logdir: not yet ported")
    ap.add_argument("--dp", action="store_true",
                    help="data parallelism: not yet ported")
    ap.add_argument("--sp", type=int, default=0,
                    help="spatial shards: not yet ported")
    return ap.parse_args(argv)


def main(argv=None, on_step=None) -> Trainer:
    """Run the CLI; returns the trainer.  ``on_step(step, metrics)`` runs
    after every step (chip_smoke.py times steps with it)."""
    args = parse_args(argv)
    if args.dp or args.sp > 1:
        raise NotImplementedError("--dp / --sp: not yet ported")
    if args.tensorboard:
        raise NotImplementedError("--tensorboard: not yet ported")
    cfg = get_config(args.config)
    if args.norm:
        cfg = dataclasses.replace(cfg, norm=args.norm)
    if cfg.norm == "batch":
        raise NotImplementedError("--norm batch (MaskedBatchNorm batch "
                                  "statistics): not yet ported")
    if cfg.name.startswith(("shapenetpart", "scenenn")):
        raise NotImplementedError(f"config {cfg.name}: not yet ported")
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.checkpoint_dir:
        cfg = dataclasses.replace(cfg, checkpoint_dir=args.checkpoint_dir)
    device = resolve_device(args.device)
    print(f"# config={args.config} device={device}", flush=True)
    if isinstance(cfg, ClassificationConfig):
        return train_classification(cfg, args, device, on_step)
    return train_segmentation(cfg, args, device, on_step)
