"""Training CLI: ``python -m pointwise_torch.train``.

A port of train.py (segmentation, SceneNN, ShapeNetPart and
classification):

  python -m pointwise_torch.train --config s3dis_synthetic_local --steps 20
  python -m pointwise_torch.train --config modelnet40_synthetic --steps 20
  python -m pointwise_torch.train --config shapenetpart --steps 20
  python -m pointwise_torch.train --config seg_tiny_local --steps 3 --device cpu
  python -m pointwise_torch.train --config seg_tiny_local --norm batch \
      --steps 3 --device cpu
  torchrun --nproc-per-node 4 -m pointwise_torch.train --dp \
      --config s3dis_synthetic_local
  torchrun --nproc-per-node 4 -m pointwise_torch.train --sp 2 \
      --config s3dis_synthetic_local

``--dp`` trains data-parallel over every rank (any configuration);
``--sp N`` shards the point dim of semantic segmentation over N ranks (the
rest data-parallel), with the model's convs on ``impl='spatial:space'``
(the gather strategy).  ``--norm batch`` trains with masked BatchNorm
(``MaskedBatchNorm``); under a mesh its moments are reduced over every
rank, so the sharded step normalizes as the single-device one does.  Rank r of a torchrun launch computes on
``cuda:<LOCAL_RANK>`` (NCCL); the CLI refuses to start with fewer cards
than local ranks.  Without a launcher ``--dp`` runs as one rank.  Every
rank builds the same global batch from the seed and trains on its shard
(``Trainer`` under a mesh); only rank 0 prints and writes checkpoints.

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

from pointwise_torch.data import (augment, modelnet, pipeline, s3dis,
                                  scenenn, shapenetpart)
from pointwise_torch.models import (
    PointwiseClassifier,
    PointwiseSegmenter,
    ShapeNetPartSegmenter,
    classification_loss,
    segmentation_loss,
)
from pointwise_torch.parallel import launch
from pointwise_torch.parallel.spmd import (cls_spmd_loss_fn,
                                           partseg_spmd_loss_fn,
                                           seg_spmd_loss_fn)
from pointwise_torch.train.configs import ClassificationConfig, get_config
from pointwise_torch.train.trainer import (SummaryWriter, Trainer,
                                           log_metrics, step_seed)

# the eval seeds sit far from the step seeds (the JAX loop's 1 << 30 offset)
_EVAL_KEY = 1 << 30
# per-point jitter sigma of segmentation training (train.py's value)
SEG_JITTER = 0.005


def run_train_loop(trainer: Trainer, cfg, args, *, make_epoch_iter,
                   steps_per_epoch: int, max_steps: int, eval_iter=None,
                   eval_split: str = "test", on_step=None) -> Trainer:
    """Deterministic, resumable training loop.

    Step ``s`` runs on seed ``step_seed(seed, s)`` and on batch
    ``s % steps_per_epoch`` of epoch ``s // steps_per_epoch``; checkpoints
    carry the seed.  ``on_step(step, metrics)`` runs after every step.
    The printed metrics also go to ``args.tensorboard`` as scalars
    (``SummaryWriter``)."""
    seed = cfg.seed
    if args.resume and cfg.checkpoint_dir:
        start = trainer.restore_checkpoint(cfg.checkpoint_dir)
        if trainer.restored_extra is not None:
            seed = int(trainer.restored_extra["seed"])
        print(f"# resumed at step {start}", flush=True)
    extra = {"seed": seed}
    device = trainer.device
    printing = trainer.mesh is None or trainer.mesh.rank == 0
    writer = SummaryWriter(args.tensorboard if printing else None)

    t0 = time.time()
    step = trainer.step_count
    try:
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
                if printing and (step % cfg.log_every == 0 or step == 1):
                    log_metrics(step, metrics, t0=t0, writer=writer)
                if eval_iter is not None and (
                        step % cfg.eval_every == 0 or step == max_steps):
                    ev = trainer.evaluate(
                        pipeline.prefetch_to_device(eval_iter(), device),
                        step_seed(seed, _EVAL_KEY + step))
                    if printing:
                        log_metrics(step, ev, t0=t0,
                                    extra={"split": eval_split},
                                    writer=writer, prefix="eval/")
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
    finally:
        writer.close()
    if cfg.checkpoint_dir:
        trainer.save_checkpoint(cfg.checkpoint_dir, cfg.keep_checkpoints,
                                extra=extra)
    return trainer


def _init_generator(cfg) -> torch.Generator:
    """Weights are drawn on the CPU from the config seed, then moved: the
    same seed gives the same initial weights on every device."""
    return torch.Generator().manual_seed(cfg.seed)


def build_classifier(cfg: ClassificationConfig, device, mesh=None,
                     remat=False):
    """The classifier (``remat``: recompute its blocks in the backward) and
    its loss (the per-cloud augmentation, then cross-entropy)."""
    model = PointwiseClassifier(
        num_classes=cfg.num_classes, channels=cfg.channels, radii=cfg.radii,
        head_dims=cfg.head_dims, dropout_rate=cfg.dropout, norm=cfg.norm,
        impl=cfg.impl, remat=remat, mesh=mesh,
        generator=_init_generator(cfg)).to(device)

    def loss_fn(model, batch, generator, train):
        pts = batch["points"]
        if train:
            pts = augment.classification_augment(pts, generator,
                                                 rotate=cfg.rotate_augment)
        loss, acc = classification_loss(model(pts), batch["label"])
        return loss, {"accuracy": acc}

    return model, loss_fn


def build_segmenter(cfg, device, mesh=None, jitter=SEG_JITTER, remat=False):
    """The segmenter and its loss (per-point jitter of sigma ``jitter``);
    under a mesh with space > 1 its convs shard the point dim
    (``impl='spatial:space'``, gather).  ``remat``: recompute its blocks in
    the backward."""
    spatial = mesh is not None and mesh.space > 1
    model = PointwiseSegmenter(
        num_classes=cfg.num_classes, in_features=cfg.in_features,
        channels=cfg.channels, radii=cfg.radii, head_dims=cfg.head_dims,
        dropout_rate=cfg.dropout, norm=cfg.norm,
        impl="spatial:space" if spatial else cfg.impl,
        remat=remat, use_global_context=cfg.global_context,
        context_axes=("space",) if spatial and cfg.global_context else (),
        mesh=mesh,
        generator=_init_generator(cfg)).to(device)

    def loss_fn(model, batch, generator, train):
        pts = batch["points"]
        if train:
            pts = augment.jitter(pts, generator, sigma=jitter, clip=0.02)
        logits = model(pts, batch["features"], batch["mask"])
        loss, acc = segmentation_loss(logits, batch["label"], batch["mask"])
        return loss, {"accuracy": acc}

    return model, loss_fn


def build_partseg(cfg, data, device, mesh=None, remat=False):
    """The part segmenter (``data.num_parts`` parts, ``data.num_categories``
    categories; ``remat``: recompute its blocks in the backward) and its
    loss; no augmentation, dropout only."""
    model = ShapeNetPartSegmenter(
        num_parts=data.num_parts, num_categories=data.num_categories,
        in_features=cfg.in_features, channels=cfg.channels, radii=cfg.radii,
        head_dims=cfg.head_dims, dropout_rate=cfg.dropout, norm=cfg.norm,
        impl=cfg.impl, remat=remat, mesh=mesh,
        generator=_init_generator(cfg)).to(device)

    def loss_fn(model, batch, generator, train):
        logits = model(batch["points"], batch["category"],
                       mask=batch["mask"])
        loss, acc = segmentation_loss(logits, batch["label"], batch["mask"])
        return loss, {"accuracy": acc}

    return model, loss_fn


def _trainer(model, loss_fn, sums_fn, cfg, mesh, **spmd):
    """The single-device trainer with ``loss_fn``, or under a mesh the one
    with the sums-contract ``sums_fn`` (parallel/spmd.py)."""
    if mesh is None:
        return Trainer(model, loss_fn, cfg.optimizer)
    return Trainer(model, sums_fn, cfg.optimizer, mesh=mesh, **spmd)


def train_classification(cfg: ClassificationConfig, args, device,
                         on_step=None, mesh=None, remat=False) -> Trainer:
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
    model, loss_fn = build_classifier(cfg, device, mesh, remat)

    def augment_clouds(batch, generator):
        # per-cloud augmentation of the global batch, before sharding
        return dict(batch, points=augment.classification_augment(
            batch["points"], generator, rotate=cfg.rotate_augment))

    trainer = _trainer(model, loss_fn, cls_spmd_loss_fn(), cfg, mesh,
                       rng_axes=("data",), global_augment=augment_clouds)
    steps_per_epoch = max(1, len(train_data.labels) // cfg.batch_size)
    return run_train_loop(
        trainer, cfg, args,
        make_epoch_iter=lambda epoch: modelnet.batches(
            train_data, cfg.batch_size, seed=cfg.seed + epoch),
        steps_per_epoch=steps_per_epoch,
        max_steps=args.steps or cfg.epochs * steps_per_epoch,
        # a mesh needs whole batches: it keeps drop_remainder
        eval_iter=lambda: modelnet.batches(test_data, cfg.batch_size,
                                           shuffle=False,
                                           drop_remainder=mesh is not None),
        on_step=on_step)


def train_segmentation(cfg, args, device, on_step=None, mesh=None,
                       jitter=SEG_JITTER, remat=False) -> Trainer:
    # heldout ROOMS for the periodic eval: overlapping-stride blocks of one
    # room share points, so a block-level split would leak
    if cfg.name.startswith("scenenn"):
        # the NYU-40 scenes (real or the 40-class procedural stand-in)
        rooms = scenenn.load_scenes(cfg.data_dir or args.data_dir,
                                    seed=cfg.seed)
    else:
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
    model, loss_fn = build_segmenter(cfg, device, mesh, jitter, remat)
    trainer = _trainer(model, loss_fn, seg_spmd_loss_fn(jitter_sigma=jitter),
                       cfg, mesh,
                       space_axis="space" if mesh and mesh.space > 1
                       else None)
    steps_per_epoch = max(1, len(blocks["points"]) // cfg.batch_size)
    return run_train_loop(
        trainer, cfg, args,
        make_epoch_iter=lambda epoch: s3dis.block_batches(
            blocks, cfg.batch_size, seed=cfg.seed + epoch),
        steps_per_epoch=steps_per_epoch,
        max_steps=args.steps or cfg.epochs * steps_per_epoch,
        eval_iter=lambda: s3dis.block_batches(eval_blocks, cfg.batch_size,
                                              shuffle=False,
                                              drop_remainder=mesh is not None),
        eval_split="heldout_rooms" if len(rooms) >= 2 else "heldout_blocks",
        on_step=on_step)


def train_shapenetpart(cfg, args, device, on_step=None, mesh=None,
                       remat=False) -> Trainer:
    """Part segmentation on the train split: dropout only, no periodic
    evaluation (``python -m pointwise_torch.eval`` scores a checkpoint)."""
    data = shapenetpart.load_shapenetpart(
        cfg.data_dir or args.data_dir, "train", cfg.num_points, seed=cfg.seed,
        variant=cfg.variant)
    model, loss_fn = build_partseg(cfg, data, device, mesh, remat)
    trainer = _trainer(model, loss_fn, partseg_spmd_loss_fn(), cfg, mesh)
    steps_per_epoch = max(1, len(data.category) // cfg.batch_size)
    return run_train_loop(
        trainer, cfg, args,
        make_epoch_iter=lambda epoch: shapenetpart.batches(
            data, cfg.batch_size, seed=cfg.seed + epoch),
        steps_per_epoch=steps_per_epoch,
        max_steps=args.steps or cfg.epochs * steps_per_epoch,
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
                         "masked BatchNorm, moments over every rank of a "
                         "mesh)")
    ap.add_argument("--tensorboard", default=None,
                    help="TensorBoard logdir of the printed metrics (a "
                         "no-op without the tensorboard package)")
    ap.add_argument("--dp", action="store_true",
                    help="data parallelism over every rank (torchrun; one "
                         "rank without a launcher)")
    ap.add_argument("--sp", type=int, default=0,
                    help="spatial shards of segmentation (mesh = data x "
                         "space over the torchrun ranks)")
    return ap.parse_args(argv)


def main(argv=None, on_step=None, mesh=None, remat=False) -> Trainer:
    """Run the CLI; returns the trainer.  ``on_step(step, metrics)`` runs
    after every step (chip_smoke.py times steps with it).  ``mesh``: run
    as this rank of an existing mesh (on its device) instead of building
    one from the launcher's environment.  ``remat``: the model's blocks
    recompute their activations in the backward (a model field, as in the
    JAX nets; no flag of the CLI)."""
    args = parse_args(argv)
    cfg = get_config(args.config)
    if args.norm:
        cfg = dataclasses.replace(cfg, norm=args.norm)
    partseg = cfg.name.startswith("shapenetpart")
    if args.sp > 1 and isinstance(cfg, ClassificationConfig):
        raise ValueError("--sp shards semantic segmentation only: the JAX "
                         "train.py trains no classifier with space shards "
                         "(its mesh for classification is --dp's)")
    if args.sp > 1 and partseg:
        raise ValueError("--sp shards semantic segmentation only; train "
                         "ShapeNetPart with --dp (as train.py does)")
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.checkpoint_dir:
        cfg = dataclasses.replace(cfg, checkpoint_dir=args.checkpoint_dir)
    device, mesh = launch.resolve_rank(args.device, args.dp, args.sp, mesh,
                                       "pointwise_torch.train")
    if mesh is None or mesh.rank == 0:
        print(f"# config={args.config} device={device}", flush=True)
        if mesh is not None:
            print(f"# mesh data:{mesh.data} x space:{mesh.space} "
                  f"backend={mesh.backend}", flush=True)
    if isinstance(cfg, ClassificationConfig):
        return train_classification(cfg, args, device, on_step, mesh, remat)
    if partseg:
        return train_shapenetpart(cfg, args, device, on_step, mesh, remat)
    return train_segmentation(cfg, args, device, on_step, mesh,
                              remat=remat)
