"""Which points can lie within a radius of which: voxel groups.

Plain PyTorch on the points' device, shared by the reference
(reference/conv.py) and the work count (work.py).  The centers are cut
into voxels of side ``max(radius, min_voxel)``; a voxel's candidates are
the points of its 27 neighbouring voxels inside its box grown by the
radius, which holds every point within the radius of any of its centers.
"""

from __future__ import annotations

import numpy as np
import torch


def voxel_groups(xyz: torch.Tensor, radius: float, *, min_voxel: float = 0.8,
                 max_centers: int = 2048):
    """Yield (center indices, candidate indices), int64 tensors on the
    device of ``xyz`` (N, 3): every point is a center of exactly one
    group, and a group's candidates hold every point within ``radius`` of
    one of its centers.  A voxel of more than ``max_centers`` points
    yields its centers in chunks with the same candidates."""
    v = max(float(radius), float(min_voxel))
    dev = xyz.device
    lo = xyz.min(dim=0).values
    k3 = torch.floor((xyz - lo) / v).long() + 1     # +1: neighbours stay >= 0
    dims = (k3.max(dim=0).values + 2).cpu().numpy().astype(np.int64)
    key = (k3[:, 0] * int(dims[1]) + k3[:, 1]) * int(dims[2]) + k3[:, 2]
    order = torch.argsort(key, stable=True)
    uniq, counts = torch.unique_consecutive(key[order], return_counts=True)
    uniq = uniq.cpu().numpy()
    ends = np.cumsum(counts.cpu().numpy())
    starts = ends - counts.cpu().numpy()
    offs = np.array([(dx * dims[1] + dy) * dims[2] + dz
                     for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], np.int64)
    nb = uniq[:, None] + offs[None, :]
    pos = np.searchsorted(uniq, nb)
    hit = (pos < len(uniq)) & (uniq[np.minimum(pos, len(uniq) - 1)] == nb)
    for u in range(len(uniq)):
        cand_pos = np.concatenate([np.arange(starts[p], ends[p])
                                   for p in pos[u][hit[u]]])
        cand = order[torch.from_numpy(cand_pos).to(dev)]
        centers = order[int(starts[u]):int(ends[u])]
        c = xyz[centers]
        box_lo = c.min(dim=0).values - radius
        box_hi = c.max(dim=0).values + radius
        p = xyz[cand]
        cand = cand[((p >= box_lo) & (p <= box_hi)).all(dim=1)]
        for s in range(0, len(centers), max_centers):
            yield centers[s:s + max_centers], cand
