"""Spawned ranks on one machine, and the workers they run.

``spawn(fn, world, workdir, ...)`` starts ``world`` processes with
``torch.multiprocessing`` (start method ``spawn``).  Each joins one gloo (or
the asked-for backend) process group through a ``FileStore`` in
``workdir`` (no ports), builds the (data x space) mesh, runs
``fn(mesh, **kwargs)`` and saves what it returns; the parent waits for all
of them within ``timeout`` seconds, kills every rank as soon as one fails
or the time is up, and raises.  It returns the ranks' results in rank
order.  The workers below are what the port's multi-process tests and
``chip_smoke.py`` run; they import nothing but the port.

torchrun launches the train CLI the same way on a multi-card machine
(``torchrun --nproc-per-node N -m pointwise_torch.train --dp ...``); this
module is for runs that need no launcher, on the CPU or on one card.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pointwise_torch import resolve_device
from pointwise_torch.parallel.mesh import make_mesh, shard_batch


def _entry(rank, world, store_path, fn, kwargs, out_path, shape, backend,
           device, timeout_s, threads):
    torch.set_num_threads(threads)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=timeout)
    try:
        mesh = make_mesh(*shape, device=device, backend=backend,
                         timeout=timeout)
        result = fn(mesh, **kwargs)
        torch.save(result, out_path + ".tmp")
        os.replace(out_path + ".tmp", out_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, workdir: str, *, data: int | None = None,
          space: int = 1, kwargs: dict | None = None, backend: str = "gloo",
          device: str | None = None, timeout: float = 120.0,
          comm_timeout: int = 60, threads: int = 1) -> list:
    """Run ``fn(mesh, **kwargs)`` on ``world`` spawned ranks (mesh
    ``data`` x ``space``) on ``device``, which defaults to the card
    (``resolve_device``: raises with no card; pass ``device='cpu'`` for the
    CPU); returns their results in rank order.  Raises if a rank fails or
    the ranks outlast ``timeout`` seconds (every rank is killed first);
    ``comm_timeout`` bounds each collective."""
    device = str(resolve_device(device))
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(
        r, world, store, fn, kwargs or {}, outs[r], (data, space), backend,
        device, comm_timeout, threads)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} exited with code "
                                   f"{procs[failed[0]].exitcode}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
            procs[0].join(0.05)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(o, weights_only=False) for o in outs]


# ---- workers ---------------------------------------------------------------


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in arrays.items()}


class KernelProbe:
    """Records the candidate rows of every feature tensor a conv kernel
    wrapper is given or returns in this process (``max_rows``): wraps the
    wrappers in the kernel module and the op layer's references to them,
    until ``close()``."""

    def __init__(self):
        import importlib

        self.max_rows = 0
        self._mods = [importlib.import_module(m) for m in (
            "pointwise_torch.kernels.pointwise_conv_cuda",
            "pointwise_torch.ops.pointwise_conv")]
        self._saved = []
        for mod in self._mods:
            for name, rows_of in (("conv_fwd", lambda a, out: a[2]),
                                  ("conv_dw", lambda a, out: a[2]),
                                  ("conv_dx", lambda a, out: out)):
                orig = getattr(mod, name)
                self._saved.append((mod, name, orig))
                setattr(mod, name, self._wrap(orig, rows_of))

    def _wrap(self, orig, rows_of):
        def probe(*args, **kw):
            out = orig(*args, **kw)
            self.max_rows = max(self.max_rows, rows_of(args, out).shape[1])
            return out
        return probe

    def close(self):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)


def conv_worker(mesh, *, problem: dict, gdir: np.ndarray, radius: float,
                strategy: str, precision: str = "float32",
                probe: bool = False) -> dict:
    """``spatial_pointwise_conv`` on this rank's slab of a global problem
    (points, features, optional mask; weights and bias replicated), then
    the backward of sum(y * gdir).  Returns the local y, the local feature
    gradient, this rank's share of the weight and bias gradients (their sum
    over the ranks is the global gradient) and, with ``probe``, the most
    candidate rows any conv kernel saw."""
    from pointwise_torch.parallel.spatial import spatial_pointwise_conv

    dev = mesh.device
    per_point = {k: problem[k] for k in ("points", "features", "mask")
                 if k in problem}
    local = shard_batch(mesh, _tensors(dict(per_point, gdir=gdir), dev))
    f = local["features"].requires_grad_(True)
    w = torch.as_tensor(problem["weights"]).to(dev).requires_grad_(True)
    b = torch.as_tensor(problem["bias"]).to(dev).requires_grad_(True)
    rec = KernelProbe() if probe else None
    try:
        y = spatial_pointwise_conv(local["points"], f, w, b, radius=radius,
                                   group=mesh.group("space"),
                                   mask_local=local.get("mask"),
                                   strategy=strategy, precision=precision)
        (y * local["gdir"]).sum().backward()
    finally:
        if rec is not None:
            rec.close()
    return {"y": y.detach().cpu(), "d_features": f.grad.cpu(),
            "d_weights": w.grad.cpu(), "d_bias": b.grad.cpu(),
            "max_rows": None if rec is None else rec.max_rows,
            "coords": mesh.coords,
            "space_ranks": dist.get_process_group_ranks(mesh.group("space")),
            "data_ranks": dist.get_process_group_ranks(mesh.group("data"))}


def train_worker(mesh, *, kind: str, model_kwargs: dict, state: dict,
                 opt_cfg, batches: list, seeds: list, space_axis=None,
                 rng_axes=None, jitter_sigma: float = 0.0,
                 eval_batches: list | None = None,
                 checkpoint_dir: str | None = None, save_after: int = 0,
                 restore: bool = False) -> dict:
    """Trainer steps under the mesh with the sums-contract loss of ``kind``
    ("seg" or "cls") on global numpy batches, one per seed.  With
    ``restore`` the trainer first restores ``checkpoint_dir``; with
    ``save_after`` it checkpoints there after that many steps.  Returns the
    per-step metrics, the evaluation of ``eval_batches`` and the final
    state_dict."""
    from pointwise_torch.models import PointwiseClassifier, PointwiseSegmenter
    from pointwise_torch.parallel.spmd import cls_spmd_loss_fn, seg_spmd_loss_fn
    from pointwise_torch.train.trainer import Trainer

    dev = mesh.device
    cls = PointwiseSegmenter if kind == "seg" else PointwiseClassifier
    model = cls(**model_kwargs, mesh=mesh, device=dev)
    model.load_state_dict(state)
    loss_fn = (seg_spmd_loss_fn(jitter_sigma=jitter_sigma) if kind == "seg"
               else cls_spmd_loss_fn())
    trainer = Trainer(model, loss_fn, opt_cfg, mesh=mesh,
                      space_axis=space_axis, rng_axes=rng_axes)
    if restore:
        trainer.restore_checkpoint(checkpoint_dir)
    metrics = []
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        m = trainer.step(_tensors(batch, dev), seed)
        metrics.append({k: float(v) for k, v in m.items()})
        if checkpoint_dir and save_after and i + 1 == save_after:
            trainer.save_checkpoint(checkpoint_dir, extra={"seed": seed})
    ev = None
    if eval_batches:
        ev = trainer.evaluate([_tensors(b, dev) for b in eval_batches], 0)
    return {"metrics": metrics, "eval": ev, "step": trainer.step_count,
            "restored_extra": trainer.restored_extra,
            "state": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()}}


def cli_worker(mesh, *, argv: list) -> dict:
    """``python -m pointwise_torch.train`` in this rank, under the mesh:
    returns every step's metrics and the final state_dict."""
    from pointwise_torch.train import cli

    metrics = []
    trainer = cli.main(argv, mesh=mesh, on_step=lambda step, m: metrics.append(
        {k: float(v) for k, v in m.items()}))
    return {"metrics": metrics, "step": trainer.step_count,
            "state": {k: v.detach().cpu()
                      for k, v in trainer.model.state_dict().items()}}
