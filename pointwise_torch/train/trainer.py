"""Training runtime: optimizer, step, evaluation, checkpoints, metrics.

A port of pointwise_tpu/train/trainer.py for one device:

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
    extra} (``torch.save``; the JAX package's orbax checkpoints are not
    read);
  * ``log_metrics`` prints one JSON line per record.

Randomness: ``step`` takes an integer seed; the augmentation generator and
the dropout seed both derive from it, so a step replays exactly from
(seed, weights, optimizer state, batch).  Loss contract:
``loss_fn(model, batch, generator, train) -> (loss, {name: scalar})``.
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

from pointwise_torch.train.configs import OptimizerConfig

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
    """Single-device trainer around (model, loss_fn)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 opt_cfg: OptimizerConfig):
        self.model = model
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer, self.schedule = make_optimizer(self.params, opt_cfg)
        self.device = self.params[0].device
        self.step_count = 0
        self.restored_extra = None

    def _randomness(self, seed: int):
        """(augmentation generator on the device, dropout seed)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(seed, 0))
        return gen, step_seed(seed, 1)

    def step(self, batch: dict, seed: int) -> dict:
        """One update; returns the loss_fn's metrics plus ``loss`` and
        ``grad_norm`` (before clipping) as device scalars."""
        self.model.train()
        gen, drop_seed = self._randomness(seed)
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(drop_seed)
            loss, metrics = self.loss_fn(self.model, batch, gen, True)
            self.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = clip_by_global_norm(grads, self.opt_cfg.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step_count)
        self.optimizer.step()
        self.step_count += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(loss=loss.detach(), grad_norm=norm.detach())
        return out

    @torch.no_grad()
    def evaluate(self, batches, seed: int, weight_fn=None) -> dict:
        """Weighted mean metrics over ``batches``: each batch's means weigh
        by its mask count when it has a ``mask``, by its row count
        otherwise, or by ``weight_fn(batch)``."""
        self.model.eval()
        gen, _ = self._randomness(seed)
        total, wsum = {}, 0.0
        for batch in batches:
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
        ``keep`` checkpoints of the directory."""
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
        when the directory holds none.  The saved ``extra`` lands in
        ``restored_extra``."""
        self.restored_extra = None
        steps = checkpoint_steps(directory)
        if step is None and not steps:
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


def log_metrics(step: int, metrics: dict, *, t0: float | None = None,
                extra: dict | None = None) -> dict:
    """Print (and return) one JSON record: step, float metrics, elapsed
    seconds since ``t0``, and ``extra`` keys."""
    rec = {"step": step}
    rec.update({k: float(v) for k, v in metrics.items()})
    if t0 is not None:
        rec["elapsed_s"] = round(time.time() - t0, 3)
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec
