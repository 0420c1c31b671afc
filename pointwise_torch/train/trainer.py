"""Training runtime: optimizer, step, evaluation, checkpoints, metrics.

A port of pointwise_tpu/train/trainer.py:

  * ``make_optimizer``: AdamW with linear warmup and cosine decay of the
    learning rate (the values of ``optax.warmup_cosine_decay_schedule``)
    and, in ``Trainer.step``, global-norm clipping as
    ``optax.clip_by_global_norm`` does it (no epsilon in the norm, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Weight decay applies to every
    parameter, as optax's unmasked ``adamw`` does;
  * ``Trainer``: one step = forward, backward (the conv kernels' dW and dX
    through ``PointwiseConvFunction``), clip, update; ``evaluate`` returns
    mask-weighted means over batches;
  * checkpoints keep the newest ``keep`` files of {step, model, optimizer,
    extra} (``torch.save``).  A run of the JAX trainer (orbax step
    directories) is not resumed: its optimizer state and PRNG keys have no
    counterpart here (infer and eval read its weights);
  * ``log_metrics`` prints one JSON line per record and, through a
    ``SummaryWriter``, logs its metrics as TensorBoard scalars.

Randomness: ``step`` takes an integer seed; the augmentation generator and
the dropout seed both derive from it, so a step replays exactly from
(seed, weights, optimizer state, batch).  Loss contract:
``loss_fn(model, batch, generator, train) -> (loss, {name: scalar})``.

Under a mesh (``mesh=``, parallel/mesh.py: data parallelism, and with
``space_axis='space'`` spatial parallelism) every rank is given the same
global batch and trains on its (batch-shard, point-shard).  The loss
contract becomes SUMS (parallel/spmd.py):

    loss_fn(model, batch, generator, train) -> (loss_sum, weight, sums)

each the local shard's.  The trainer sums loss, weight, metrics and every
gradient over the mesh in one all-reduce and divides by the summed weight
before clipping, so the sharded step equals the unsharded global-mean step,
and clipping, AdamW and the schedule run on identical values on every
rank.  Parameters are broadcast from rank 0 at construction.  The
generator and dropout seeds fold in the rank's coordinates along
``rng_axes`` (default both axes: independent per-point noise per shard);
``global_augment(batch, generator)`` runs on the global batch before
sharding, with the unfolded generator, for per-cloud augmentation.  Only
rank 0 writes checkpoints; every rank restores.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from pointwise_torch.convert import numbered_dirs
from pointwise_torch.parallel.mesh import all_reduce, broadcast_, shard_batch
from pointwise_torch.train.configs import OptimizerConfig
from pointwise_torch.utils.runtime import span

_CKPT = re.compile(r"ckpt_(\d+)\.pt")


def lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate after ``count`` updates: linear from 1% of the peak to
    the peak over ``warmup_steps``, then cosine down to ``min_lr_ratio`` of
    the peak at ``decay_steps`` (warmup included), constant after."""
    peak = cfg.learning_rate
    init, end = peak * 0.01, peak * cfg.min_lr_ratio
    alpha = 0.0 if peak == 0.0 else end / peak
    warm, decay = cfg.warmup_steps, cfg.decay_steps - cfg.warmup_steps
    if decay <= 0:
        raise ValueError(f"decay_steps ({cfg.decay_steps}) must exceed "
                         f"warmup_steps ({cfg.warmup_steps})")

    def schedule(count: int) -> float:
        if count < warm:
            return (init - peak) * (1.0 - count / warm) + peak
        t = min(count - warm, decay)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay))
                       + alpha)

    return schedule


def make_optimizer(params, cfg: OptimizerConfig):
    """(AdamW over ``params``, learning-rate schedule); the trainer sets the
    rate from the schedule before every update."""
    schedule = lr_schedule(cfg)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(cfg.b1, cfg.b2),
                            eps=1e-8, weight_decay=cfg.weight_decay)
    return opt, schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to global norm ``max_norm`` when their norm
    is not below it (optax.clip_by_global_norm); returns the norm before
    clipping.  Stays on the device: no host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def step_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from ``seed`` and ``keys`` (the port's
    ``fold_in``)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


class Trainer:
    """Trainer around (model, loss_fn): one device, or one rank of a mesh
    (see the module docstring)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 opt_cfg: OptimizerConfig, *, mesh=None,
                 space_axis: str | None = None, rng_axes=None,
                 global_augment: Callable | None = None):
        self.model = model
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer, self.schedule = make_optimizer(self.params, opt_cfg)
        self.device = self.params[0].device
        self.step_count = 0
        self.restored_extra = None
        self.mesh = mesh
        self.global_augment = global_augment
        if mesh is None:
            if space_axis is not None or rng_axes is not None:
                raise ValueError("space_axis and rng_axes need a mesh")
            return
        if space_axis not in (None, "space"):
            raise ValueError(f"space_axis must be 'space', got {space_axis!r}")
        if space_axis is None and mesh.space > 1:
            raise ValueError("a mesh with space > 1 needs space_axis='space' "
                             "(and a model built with impl='spatial:space')")
        self.rng_axes = tuple(("data", "space") if rng_axes is None
                              else rng_axes)
        # every rank starts from rank 0's parameters and buffers
        broadcast_([*model.parameters(), *model.buffers()],
                   mesh.group("world"))

    def _randomness(self, seed: int):
        """(augmentation generator on the device, dropout seed); under a mesh
        both fold in this rank's coordinates along ``rng_axes``."""
        keys = ([] if self.mesh is None
                else [self.mesh.index(a) for a in self.rng_axes])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(seed, 0, *keys))
        return gen, step_seed(seed, 1, *keys)

    def step(self, batch: dict, seed: int) -> dict:
        """One update; returns the loss_fn's metrics plus ``loss`` and
        ``grad_norm`` (before clipping) as device scalars.  Under a mesh
        ``batch`` is the global batch and the metrics are global means.
        Its phases are ``runtime.span``s for a profiler's trace:
        train.forward (the dropout seed and the loss function),
        train.backward, train.clip and train.optimizer (the schedule and
        AdamW)."""
        self.model.train()
        gen, drop_seed = self._randomness(seed)
        if self.mesh is not None:
            if self.global_augment is not None:
                glob = torch.Generator(device=self.device)
                glob.manual_seed(step_seed(seed, 0))
                batch = self.global_augment(batch, glob)
            batch = shard_batch(self.mesh, batch)
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            with span("train.forward"):
                torch.manual_seed(drop_seed)
                res = self.loss_fn(self.model, batch, gen, True)
            with span("train.backward"):
                self.optimizer.zero_grad(set_to_none=False)
                res[0].backward()
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.mesh is None:
            loss, metrics = res
        else:
            loss, metrics, _ = self._sum_over_mesh(res, grads)
        with span("train.clip"):
            norm = clip_by_global_norm(grads, self.opt_cfg.grad_clip)
        with span("train.optimizer"):
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step_count)
            self.optimizer.step()
        self.step_count += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(loss=loss.detach(), grad_norm=norm.detach())
        return out

    def _sum_over_mesh(self, out, grads=()):
        """The sums contract: (loss_sum, weight, sums) and ``grads`` summed
        over the mesh in one all-reduce, each divided by the summed weight
        (grads in place).  Returns (global loss, global metric means,
        summed weight)."""
        loss_sum, weight, sums = out
        names = sorted(sums)
        head = torch.stack([loss_sum.detach().float(), weight.float()]
                           + [sums[k].detach().float() for k in names])
        tot = all_reduce(torch.cat([head] + [g.reshape(-1).float()
                                             for g in grads]),
                         self.mesh.group("world"))
        total_w = tot[1]
        off = len(head)
        with torch.no_grad():
            for g in grads:
                g.copy_((tot[off:off + g.numel()].view_as(g)
                         / total_w).to(g.dtype))
                off += g.numel()
        metrics = {k: tot[2 + i] / total_w for i, k in enumerate(names)}
        return tot[0] / total_w, metrics, total_w

    @torch.no_grad()
    def evaluate(self, batches, seed: int, weight_fn=None) -> dict:
        """Weighted mean metrics over ``batches``: each batch's means weigh
        by its mask count when it has a ``mask``, by its row count
        otherwise, or by ``weight_fn(batch)``.  Under a mesh each batch is
        the global batch, and its weight and means (``loss`` among them)
        are the sums contract's, so the result is the global weighted
        mean."""
        self.model.eval()
        gen, _ = self._randomness(seed)
        total, wsum = {}, 0.0
        for batch in batches:
            if self.mesh is not None:
                out = self.loss_fn(self.model, shard_batch(self.mesh, batch),
                                   gen, False)
                loss, metrics, w = self._sum_over_mesh(out)
                metrics = dict(metrics, loss=loss)
                w = float(w)
                for k, v in metrics.items():
                    total[k] = total.get(k, 0.0) + float(v) * w
                wsum += w
                continue
            _, metrics = self.loss_fn(self.model, batch, gen, False)
            if weight_fn is not None:
                w = float(weight_fn(batch))
            elif "mask" in batch:
                w = float(batch["mask"].sum())
            else:
                w = float(next(iter(batch.values())).shape[0])
            for k, v in metrics.items():
                total[k] = total.get(k, 0.0) + float(v) * w
            wsum += w
        if not total:
            raise ValueError(
                "evaluate() received no batches — eval split smaller than "
                "the batch size with drop_remainder, or an empty iterator")
        return {k: v / max(wsum, 1e-9) for k, v in total.items()}

    # ---- checkpoints ----------------------------------------------------

    def save_checkpoint(self, directory: str, keep: int = 3,
                        extra: dict | None = None) -> int:
        """Write ``ckpt_<step>.pt`` (atomically) and keep the newest
        ``keep`` checkpoints of the directory.  Under a mesh rank 0 writes
        and every rank waits for it."""
        if self.mesh is not None:
            if self.mesh.rank == 0:
                self._write_checkpoint(directory, keep, extra)
            dist.barrier(group=self.mesh.group("world"))
            return self.step_count
        return self._write_checkpoint(directory, keep, extra)

    def _write_checkpoint(self, directory, keep, extra):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"ckpt_{self.step_count:08d}.pt")
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save({"step": self.step_count,
                    "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "extra": extra}, tmp)
        os.replace(tmp, path)
        for old in checkpoint_steps(directory)[:-keep]:
            os.remove(os.path.join(directory, f"ckpt_{old:08d}.pt"))
        return self.step_count

    def restore_checkpoint(self, directory: str,
                           step: int | None = None) -> int:
        """Load the newest checkpoint (or ``step``); returns its step, 0
        when the directory holds none; refuses a directory of the JAX
        trainer's orbax steps (``ValueError``).  The saved ``extra`` lands in
        ``restored_extra``."""
        self.restored_extra = None
        steps = checkpoint_steps(directory)
        if step is None and not steps:
            if numbered_dirs(directory):
                raise ValueError(
                    f"{directory} holds orbax checkpoints of the JAX trainer "
                    "and none of the port's: the JAX optimizer state and "
                    "PRNG keys do not carry over to the port's trainer, so "
                    "its run is not resumed here (train.py resumes it; "
                    "infer and eval --checkpoint-dir read its weights)")
            return 0
        state = load_checkpoint(directory, step, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])
        self.restored_extra = state.get("extra")
        return self.step_count


def checkpoint_steps(directory: str) -> list:
    """Steps of the trainer checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _CKPT.fullmatch(f)))


def load_checkpoint(directory: str, step: int | None = None,
                    map_location=None) -> dict:
    """The checkpoint dict {step, model, optimizer, extra} of ``step``, or
    of the newest step in ``directory``."""
    if step is None:
        steps = checkpoint_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no trainer checkpoint in {directory}")
        step = steps[-1]
    return torch.load(os.path.join(directory, f"ckpt_{step:08d}.pt"),
                      map_location=map_location, weights_only=True)


class SummaryWriter:
    """TensorBoard scalars under ``logdir`` (``torch.utils.tensorboard``),
    as the JAX package's tf.summary writer logs them; without the
    tensorboard package (or with no ``logdir``) a no-op, which says once
    that no scalars are written."""

    def __init__(self, logdir: str | None):
        self._writer = None
        if not logdir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError:
            print(f"# --tensorboard {logdir}: the tensorboard package is "
                  "missing, no scalars are written", flush=True)
            return
        self._writer = _Writer(logdir)

    def scalars(self, step: int, metrics: dict, prefix: str = ""):
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(prefix + k, float(v), step)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


def log_metrics(step: int, metrics: dict, *, t0: float | None = None,
                extra: dict | None = None,
                writer: SummaryWriter | None = None,
                prefix: str = "") -> dict:
    """Print (and return) one JSON record: step, float metrics, elapsed
    seconds since ``t0``, and ``extra`` keys; ``writer`` logs the metrics
    as scalars named ``prefix + name``."""
    rec = {"step": step}
    rec.update({k: float(v) for k, v in metrics.items()})
    if t0 is not None:
        rec["elapsed_s"] = round(time.time() - t0, 3)
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    if writer is not None:
        writer.scalars(step, metrics, prefix)
    return rec
