"""The part segmenter's training loop: ``train.cli.build_partseg`` and
``cli._trainer`` stepped as the training CLI's ``train_shapenetpart``
steps them (``pipeline.prefetch_to_device`` -> ``Trainer.step(batch,
step_seed(seed, step))``), over a pool of distinct batches of
category-conditioned shapes made at set-up and cycled.  No augmentation:
the CLI trains the part segmenter with dropout only.

It returns the record ``benchmark/train.py`` returns (kind ``train``), so
every training reader reads it; set-up runs the first steps, whose
losses, first gradient and change the reference is held to, as there.
"""

from __future__ import annotations

import gc
import itertools
import math
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import cell, check, devtrace, traffic, weights, work
from benchmark.frozen import augment
from benchmark.frozen.partseg import part_set
from benchmark.reference import models as ref_models
from benchmark.reference.partseg import partseg_logits
from benchmark.reference.precision import round_fp8
from benchmark.train import _adamw, _batch

EMBED = 64      # the category embedding's width (ShapeNetPartSegmenter)


def head_in(cfg) -> int:
    """The head's input width: every block, the last one's max and mean,
    and the category's embedding."""
    return sum(cfg["channels"]) + 2 * cfg["channels"][-1] + EMBED


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``weights.shapes`` of the net plus ``embed.*``, drawn from ``seed``
    in one normal draw on the device and scaled as ``weights.make``
    scales each kind."""
    spec = weights.shapes(cfg, cfg["in_features"], head_in(cfg)) + [
        ("embed.weight", (EMBED, cfg["num_categories"]), "linear"),
        ("embed.bias", (EMBED,), "bias")]
    total = sum(math.prod(s) for _, s, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = z[off:off + n].reshape(shape)
        off += n
        if kind == "kernel":
            t = t / math.sqrt(27 * shape[1])
        elif kind == "linear":
            t = t / math.sqrt(shape[1])
        elif kind == "scale":
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.contiguous()
    return out


def batch_pool(cfg: dict, mix: dict, seed: int) -> list:
    """``mix["pool_batches"]`` distinct batches in the program's format:
    ``points`` (B, N, 3) f32, ``category`` (B,) i32, ``label`` (B, N) i32
    and an all-ones ``mask`` (B, N) f32."""
    if mix["data"] != "part_clouds":
        raise ValueError(f"the part segmenter's loop makes part_clouds, "
                         f"not {mix['data']!r}")
    bs, n, npts = cfg["batch_size"], mix["pool_batches"], cfg["num_points"]
    pts, cats, part = part_set(traffic.sub_seed(seed, 10), bs * n, npts)
    mask = np.ones((bs, npts), np.float32)
    return [{"points": pts[i * bs:(i + 1) * bs],
             "category": cats[i * bs:(i + 1) * bs],
             "label": part[i * bs:(i + 1) * bs], "mask": mask}
            for i in range(n)]


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, limits: dict, log) -> dict:
    """One run; returns the record the metric readers read."""
    from pointwise_torch.data import pipeline
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels
    from pointwise_torch.train import cli
    from pointwise_torch.train.trainer import step_seed

    dev = torch.device(device)
    pcfg = cell.port_config(cfg)
    model, loss_fn = cli.build_partseg(
        pcfg, SimpleNamespace(num_parts=cfg["num_classes"],
                              num_categories=cfg["num_categories"]), dev)
    precision = {blk.conv.precision for blk in model.blocks}
    if precision != {cfg["precision"]}:
        raise ValueError(f"the program's convs run in {precision}, the "
                         f"configuration states {cfg['precision']}")
    w = make_weights(cfg, traffic.sub_seed(seed, 1), dev)
    model.load_state_dict(w, strict=True)
    trainer = cli._trainer(model, loss_fn, None, pcfg, None)
    pool = batch_pool(cfg, mix, seed)
    feed = pipeline.prefetch_to_device(itertools.cycle(pool), dev)
    count = itertools.count()

    def step():
        s = next(count)
        with record_function("harness.next_batch"):
            batch = next(feed)
        with record_function("harness.trainer_step"):
            return trainer.step(batch, step_seed(seed, s))

    first = mix["first_steps"]
    params = dict(trainer.model.named_parameters())
    losses = []
    for s in range(first):
        losses.append(float(step()["loss"]))
        if s == 0:      # the first moment of Adam: (1 - b1) x gradient
            state = trainer.optimizer.state
            grad = {k: (state[p]["exp_avg"] if "exp_avg" in state[p]
                        else torch.zeros_like(p)) / (1.0 - pcfg.optimizer.b1)
                    for k, p in params.items()}
    change = {k: p.detach() - w[k] for k, p in params.items()}
    devtrace.sync(dev)
    setup_s = time.perf_counter() - t_start

    kernels.reset_launches()
    peak_setup = 0
    if dev.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    steps = half = 0
    t0 = time.perf_counter()
    while True:
        step()
        steps += 1
        now = time.perf_counter() - t0
        if not half and now >= seconds / 2:
            half = steps
        if now >= seconds:
            break
    devtrace.sync(dev)
    rec = dict(kind="train", setup_s=setup_s,
               window_s=time.perf_counter() - t0, steps=steps,
               attempted=first + steps, failed=0,
               points_per_step=cfg["batch_size"] * cfg["num_points"],
               launches=dict(kernels.LAUNCHES))
    if dev.type == "cuda":
        rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["memory_peak_bytes"] = max(rec["window_peak_bytes"],
                                       peak_setup)
    else:
        rec["window_peak_bytes"] = rec["memory_peak_bytes"] = 0

    if trace:
        traced_from = first + steps
        rec["trace"] = devtrace.traced(lambda k: step(),
                                      mix["profile_steps"], dev)
        if dev.type == "cuda":
            rec["memory_peak_bytes"] = max(
                rec["memory_peak_bytes"], torch.cuda.max_memory_allocated(dev))
    del trainer, model, feed, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log(f"# set-up {setup_s:.2f} s, window {rec['window_s']:.2f} s, "
        f"{steps} steps, {half} in its first half")
    if trace:
        t = time.perf_counter()
        rec["work"] = _work(cfg, pool, first, steps, traced_from,
                            mix["profile_steps"], dev)
        log(f"# work count {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    port = dict(losses=losses, grad=grad, change=change)
    ref = reference_steps(cfg, pool, seed, w, first, dev)
    rec["checks"] = check.judge(check.training_gaps(port, ref, log), limits)
    log(f"# reference {time.perf_counter() - t:.2f} s")
    return rec


def reference_steps(cfg, pool, seed, w0, n, dev, rnd=None) -> dict:
    """The reference's first ``n`` steps from the weights ``w0`` on the
    pool's first batches, drawing each step's dropout from the seed the
    trainer draws it from: the losses, the first clipped gradient and the
    parameters' change (``benchmark.train.reference_steps``' contract).
    ``rnd``: the precision control's rounding."""
    opt = cfg["optimizer"]
    sched = augment.lr_schedule(opt["learning_rate"], opt["warmup_steps"],
                                opt["decay_steps"], opt["min_lr_ratio"])
    p = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    losses, first_grad = [], None
    with ref_models.float32_exact():
        for s in range(n):
            batch = _batch(pool, s, dev)
            devices = [dev] if dev.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(augment.step_seed(
                    augment.step_seed(seed, s), 1))
                logits = partseg_logits(
                    p, cfg["radii"], batch["points"], batch["category"],
                    batch["mask"], cfg["dropout"], rnd=rnd)
                loss = ref_models.segmentation_loss(
                    logits, batch["label"], batch["mask"])
            names = list(p)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if not norm < opt["grad_clip"]:
                grads = [g / norm * opt["grad_clip"] for g in grads]
            grads = dict(zip(names, grads))
            if first_grad is None:
                first_grad = {k: g.detach() for k, g in grads.items()}
            _adamw(p, m, v2, grads, sched(s), s + 1, opt)
            losses.append(float(loss.detach()))
    return dict(losses=losses, grad=first_grad,
                change={k: p[k].detach() - w0[k] for k in p})


def control_readings(workload: str, seed: int, device="cuda") -> dict:
    """The compared numbers of the precision control (the reference with
    its convs' inputs in fp8) against the reference, on what a run of
    ``workload`` with ``seed`` checks: ``calibrate.control_readings`` for
    this loop, whose batches and weights that one does not make."""
    bench = cell.load_benchmark()
    c, centry = cell.find(bench, workload)
    cfg = cell.load_json(cell.ROOT, centry["file"])
    mix = traffic.load(c["traffic"])
    dev = torch.device(device)
    w = make_weights(cfg, traffic.sub_seed(seed, 1), dev)
    pool = batch_pool(cfg, mix, seed)
    n = mix["first_steps"]
    ref = reference_steps(cfg, pool, seed, w, n, dev)
    low = reference_steps(cfg, pool, seed, w, n, dev, rnd=round_fp8)
    return check.training_gaps(low, ref)


def _work(cfg, pool, first, steps, traced_from, traced, dev) -> dict:
    """Useful operations of the window's steps and the conv least seconds
    of the traced steps, from the harness's own pair counts on each
    distinct batch: the trunk's forward, dW and dX, the head's Linear
    layers over every point (forward, dW and dX) and the embedding's over
    every shape (forward and dW: the one-hot takes no gradient)."""
    widths = [cfg["in_features"], *cfg["channels"]]
    dims = [head_in(cfg), *cfg["head_dims"], cfg["num_classes"]]
    bs = cfg["batch_size"]
    per_batch = []
    for s in range(len(pool)):
        batch = _batch(pool, s, dev)
        pairs = work.cloud_pairs(batch["points"], cfg["radii"],
                                 batch["mask"])
        real = int(batch["mask"].sum())
        ops, least = work.train_step_work(pairs, real, widths)
        ops += work.head_ops(bs * cfg["num_points"], dims, 3)
        ops += work.head_ops(bs, [cfg["num_categories"], EMBED], 2)
        per_batch.append((ops, least))

    def total(start, n, i):
        return sum(per_batch[s % len(pool)][i]
                   for s in range(start, start + n))

    return dict(window_ops=total(first, steps, 0),
                traced_conv_least_s=total(traced_from, traced, 1))
