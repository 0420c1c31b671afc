"""Process-group mesh over (data x space) ranks, and its collectives.

A port of pointwise_tpu/parallel/mesh.py on ``torch.distributed``.  The JAX
package names two mesh axes:

  * ``data``  — batch-dim data parallelism;
  * ``space`` — point-dim ("spatial") parallelism for scans that exceed one
    device (parallel/spatial.py).

Here a mesh is a layout of the ranks of the default process group: rank r
sits at (data index, space index) = ``divmod(r, space)``.  Each data row
(the ranks that share a data index) is a process group, the ``space``
group of its members; each space column is the ``data`` group of its
members; ``world`` spans the mesh.  Every rank creates every group, in the
same order, as ``torch.distributed.new_group`` requires.

The backend is an explicit argument: ``nccl`` by default for CUDA devices,
``gloo`` for the CPU.  A caller that puts several ranks on one card asks
for ``gloo`` (NCCL refuses two ranks on one device); gloo communication of
CUDA tensors is staged through host memory here.  Nothing switches backend
on an error.

Convs with ``impl='spatial:<axis>'`` and the models' ``context_axes`` find
their process groups through the mesh they are given (``mesh=``), where the
JAX package finds its axis names bound by ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from pointwise_torch import resolve_device

AXES = ("data", "space")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data x space) layout of the ranks.

    ``groups`` maps "data", "space" and "world" to this rank's process
    groups; ``device`` is the device this rank computes on."""

    data: int
    space: int
    rank: int
    backend: str
    device: torch.device
    groups: dict

    @property
    def coords(self) -> tuple:
        """(data index, space index) of this rank."""
        return divmod(self.rank, self.space)

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        if axis not in self.groups:
            raise ValueError(f"unknown mesh axis {axis!r}; axes: {AXES}")
        return self.groups[axis]


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: str | None = None, device=None) -> bool:
    """Join the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    the card).  Returns True when the process group is (now) initialized,
    False when no launcher configured one: a no-op, so CLIs can call it
    unconditionally.  Reads no other variable and contacts nothing but the
    address it was given.  Without ``backend`` the backend follows
    ``device``, which defaults to the card (``resolve_device``: raises with
    no card; pass ``device='cpu'`` for gloo on the CPU)."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR")):
        return False
    backend = backend or default_backend(resolve_device(device))
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def make_mesh(data: int | None = None, space: int = 1, *, device=None,
              backend: str | None = None,
              timeout: datetime.timedelta | None = None) -> Mesh:
    """The (data x space) mesh over every rank of the default process group
    (which must be initialized).  ``data=None`` takes the ranks that
    ``space`` leaves; ``device`` is this rank's device (default the card,
    through ``resolve_device``, which raises with no card: pass
    ``device='cpu'`` for the CPU) and picks the default backend."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torchrun and init_distributed(), or "
                           "torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if data is None:
        if n % space:
            raise ValueError(f"{n} ranks not divisible by space={space}")
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} needs {data * space} ranks, "
                         f"the process group has {n}")
    device = resolve_device(device)
    backend = backend or default_backend(device)
    rank = dist.get_rank()
    kw = {"backend": backend}
    if timeout is not None:
        kw["timeout"] = timeout
    groups = {"world": dist.new_group(list(range(n)), **kw)}
    for d in range(data):                      # data rows: space groups
        g = dist.new_group([d * space + s for s in range(space)], **kw)
        if rank // space == d:
            groups["space"] = g
    for s in range(space):                     # space columns: data groups
        g = dist.new_group([d * space + s for d in range(data)], **kw)
        if rank % space == s:
            groups["data"] = g
    return Mesh(data=data, space=space, rank=rank, backend=backend,
                device=device, groups=groups)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's (batch-shard, point-shard) of a global batch that every
    rank built alike (a port of ``host_local_batch_to_global``): arrays of
    rank >= 2 split on B over ``data`` and on N over ``space``; per-cloud
    arrays (rank 1, e.g. labels) on B only, as the JAX trainer's
    ``_spmd_specs`` lays them out."""
    d, s = mesh.coords
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.data:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not "
                             f"divisible by data={mesh.data}")
        rows = v.shape[0] // mesh.data
        v = v[d * rows:(d + 1) * rows]
        if v.ndim >= 2:
            if v.shape[1] % mesh.space:
                raise ValueError(f"batch[{k!r}] has {v.shape[1]} points, not "
                                 f"divisible by space={mesh.space}")
            n = v.shape[1] // mesh.space
            v = v[:, s * n:(s + 1) * n]
        out[k] = v.contiguous()
    return out


# ---- collectives (gloo: CUDA tensors staged through host memory) ---------


def _comm_device(group, t: torch.Tensor) -> torch.device:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return t.device


def _to_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.view(like.dtype).reshape(like.shape)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``group``, as a new tensor on t's device
    (every member gets the same bits)."""
    x = t.detach().to(_comm_device(group, t), copy=True).contiguous()
    dist.all_reduce(x, op=op, group=group)
    return x.to(t.device)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim`` in group-rank order
    (any dtype: the bytes travel)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.detach()
    x = _to_bytes(t).to(_comm_device(group, t))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat([_from_bytes(p.to(t.device), t) for p in parts], dim)


def ring_shift(tensors, group, step: int = 1):
    """Send ``tensors`` (a tuple, None entries kept as None) to the member
    ``step`` places after this one in ``group`` and return those of the
    member ``step`` places before, with the same shapes and dtypes.  All
    tensors travel as one packed buffer: one send and one receive."""
    n = dist.get_world_size(group)
    if n == 1:
        return tuple(tensors)
    live = [t for t in tensors if t is not None]
    dev = live[0].device
    cdev = _comm_device(group, live[0])
    send = torch.cat([_to_bytes(t).to(cdev) for t in live])
    recv = torch.empty_like(send)
    me = dist.get_rank(group)
    peer = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        w.wait()
    out, off = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        nb = t.numel() * t.element_size()
        out.append(_from_bytes(recv[off:off + nb].to(dev, copy=True), t))
        off += nb
    return tuple(out)


def broadcast_(tensors, group) -> None:
    """Overwrite ``tensors`` in place with global rank 0's values."""
    for t in tensors:
        x = t.detach().to(_comm_device(group, t), copy=True).contiguous()
        dist.broadcast(x, src=0, group=group)
        with torch.no_grad():
            t.copy_(x.to(t.device))


def broadcast_text(text: str | None, group, device) -> str | None:
    """Global rank 0's ``text`` (a string or None) on every member of
    ``group``; the other members' ``text`` is ignored.  ``device`` is where
    the bytes are staged (the members' device)."""
    data = (text or "").encode()
    n = torch.tensor([-1 if text is None else len(data)], dtype=torch.int64,
                     device=device)
    broadcast_([n], group)
    n = int(n)
    if n <= 0:
        return None if n < 0 else ""
    buf = torch.tensor(list(data) if len(data) == n else [0] * n,
                       dtype=torch.uint8, device=device)
    broadcast_([buf], group)
    return bytes(buf.cpu().tolist()).decode()
