"""The training loop: the program's trainer stepped as its training CLI
steps it (``pipeline.prefetch_to_device`` -> ``Trainer.step(batch,
step_seed(seed, step))``), on the model and trainer that
``train.cli.build_segmenter`` / ``build_classifier`` and ``cli._trainer``
make, over a pool of distinct batches made at set-up and cycled.

Set-up runs the first steps through the same feed and call; their
losses, the optimizer's first moment after step 1 and the parameters
after the last of them are what the reference is held to.
"""

from __future__ import annotations

import gc
import itertools
import time

import torch
from torch.profiler import record_function

from benchmark import check, devtrace, traffic, weights, work
from benchmark.cell import port_config
from benchmark.frozen import augment
from benchmark.reference import models as ref_models


def _net_inputs(cfg):
    """(first block's width, head's input width) of the net."""
    if cfg["net"] == "classifier":
        return 3, 2 * cfg["channels"][-1]
    return cfg["in_features"], sum(cfg["channels"])


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, limits: dict, log) -> dict:
    """One run; returns the record the metric readers read."""
    from pointwise_torch.data import pipeline
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels
    from pointwise_torch.train import cli
    from pointwise_torch.train.trainer import step_seed

    dev = torch.device(device)
    pcfg = port_config(cfg)
    if cfg["net"] == "classifier":
        model, loss_fn = cli.build_classifier(pcfg, dev)
    else:
        model, loss_fn = cli.build_segmenter(pcfg, dev)
    precision = {blk.conv.precision for blk in model.blocks}
    if precision != {cfg["precision"]}:
        raise ValueError(f"the program's convs run in {precision}, the "
                         f"configuration states {cfg['precision']}")
    cin, head_in = _net_inputs(cfg)
    w = weights.make(cfg, cin, head_in, traffic.sub_seed(seed, 1), dev)
    model.load_state_dict(w, strict=True)
    trainer = cli._trainer(model, loss_fn, None, pcfg, None)
    pool = traffic.batch_pool(cfg, mix, seed)
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
        rec["work"] = _work(cfg, pool, seed, first, steps, traced_from,
                            mix["profile_steps"], dev)
        log(f"# work count {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    port = dict(losses=losses, grad=grad, change=change)
    ref = reference_steps(cfg, pool, seed, w, first, dev)
    rec["checks"] = check.judge(check.training_gaps(port, ref, log), limits)
    log(f"# reference {time.perf_counter() - t:.2f} s")
    return rec


def augmented(cfg: dict, points: torch.Tensor, seed: int, s: int):
    """The points step ``s`` trains on: the training step's augmentation
    drawn again from its seed (frozen/augment.py)."""
    gen = torch.Generator(device=points.device)
    gen.manual_seed(augment.step_seed(augment.step_seed(seed, s), 0))
    if cfg["net"] == "classifier":
        return augment.classification_augment(
            points, gen, rotate=cfg["rotate_augment"])
    return augment.jitter(points, gen, sigma=cfg["jitter_sigma"],
                          clip=cfg["jitter_clip"])


def _batch(pool, s, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in pool[s % len(pool)].items()}


def reference_steps(cfg, pool, seed, w0, n, dev, rnd=None) -> dict:
    """The reference's first ``n`` steps from the weights ``w0`` on the
    pool's first batches, drawing the step's augmentation and dropout from
    the same seeds: the losses, the first clipped gradient and the
    parameters' change.  ``rnd``: the precision control's rounding."""
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
            step = augment.step_seed(seed, s)
            pts = augmented(cfg, batch["points"], seed, s)
            devices = [dev] if dev.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(augment.step_seed(step, 1))
                if cfg["net"] == "classifier":
                    logits = ref_models.classifier_logits(
                        p, cfg["radii"], pts, cfg["dropout"], rnd=rnd)
                    loss = ref_models.classification_loss(logits,
                                                          batch["label"])
                else:
                    logits = ref_models.segmenter_logits(
                        p, cfg["radii"], pts, batch["features"],
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


@torch.no_grad()
def _adamw(p, m, v, grads, lr, t, opt):
    """One AdamW update (decoupled weight decay, bias-corrected moments,
    epsilon 1e-8 outside the root), as torch.optim.AdamW does it."""
    b1, b2, wd = opt["b1"], opt["b2"], opt["weight_decay"]
    for k, g in grads.items():
        p[k].mul_(1.0 - lr * wd)
        m[k].lerp_(g, 1.0 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v[k].sqrt() / (1.0 - b2 ** t) ** 0.5).add_(1e-8)
        p[k].addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** t))


def _work(cfg, pool, seed, first, steps, traced_from, traced, dev) -> dict:
    """Useful operations of the window's steps and the conv least seconds
    of the traced steps, from the harness's own pair counts on each
    step's augmented points."""
    cin, head_in = _net_inputs(cfg)
    widths = [cin, *cfg["channels"]]
    rows = cfg["batch_size"] * cfg["num_points"]
    if cfg["net"] == "classifier":
        head = ([head_in, *cfg["head_dims"], cfg["num_classes"]],
                cfg["batch_size"])
    else:
        head = ([head_in, *cfg["head_dims"], cfg["num_classes"]], rows)

    def one(s):
        batch = _batch(pool, s, dev)
        pts = augmented(cfg, batch["points"], seed, s)
        mask = batch.get("mask")
        pairs = work.cloud_pairs(pts, cfg["radii"], mask)
        real = rows if mask is None else int(mask.sum())
        ops, least = work.train_step_work(pairs, real, widths)
        return ops + work.head_ops(head[1], head[0], 3), least

    window = [one(s) for s in range(first, first + steps)]
    traced_work = [one(s) for s in range(traced_from, traced_from + traced)]
    return dict(window_ops=sum(o for o, _ in window),
                traced_conv_least_s=sum(l for _, l in traced_work))
