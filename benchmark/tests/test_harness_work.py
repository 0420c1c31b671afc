"""The work count's pairs against a brute-force count, and its formula."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import neighbors, work


def _brute(xyz, r):
    d = xyz[:, None, :] - xyz[None, :, :]
    return int(((d * d).sum(-1) <= r * r).sum())


@pytest.mark.parametrize("radius", [0.05, 0.3, 0.9])
def test_scene_pairs_match_brute_force(radius):
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.uniform(0, 2.0, (700, 3)).astype(np.float32))
    assert work.scene_pairs(xyz, radius) == _brute(xyz, radius)


def test_voxel_groups_cover_every_center_once():
    rng = np.random.default_rng(4)
    xyz = torch.from_numpy(rng.uniform(0, 3.0, (900, 3)).astype(np.float32))
    seen = torch.zeros(len(xyz), dtype=torch.long)
    for centers, cand in neighbors.voxel_groups(xyz, 0.2, max_centers=50):
        seen[centers] += 1
        d = xyz[:, None, :] - xyz[centers][None, :, :]
        near = ((d * d).sum(-1) <= 0.04).any(dim=1).nonzero()[:, 0]
        assert set(near.tolist()) <= set(cand.tolist())
    assert bool((seen == 1).all())


def test_cloud_pairs_with_mask():
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, 64, 3)).astype(np.float32))
    mask = torch.ones(3, 64)
    mask[1, 40:] = 0
    got = work.cloud_pairs(pts, [0.3, 0.7], mask)
    for i, r in enumerate([0.3, 0.7]):
        want = sum(_brute(pts[b][mask[b] > 0], r) for b in range(3))
        assert got[i] == want


def test_conv_call_formula():
    ops, nbytes = work.conv_call("fwd", pairs=1000, rows=10, cin=6, cout=8)
    assert ops == 1000 * 6 + 2 * 27 * 6 * 8 * 10
    assert nbytes == 10 * 12 + 10 * 6 * 2 + 27 * 6 * 8 * 2 + 10 * 8 * 4
    dx_ops, _ = work.conv_call("dx", pairs=1000, rows=10, cin=6, cout=8)
    assert dx_ops == 1000 * 8 + 2 * 27 * 6 * 8 * 10
    # a training step: no dX for the first block
    ops1, _ = work.train_step_work([100, 200], 10, [6, 8, 8])
    want = sum(work.conv_call(k, 100, 10, 6, 8)[0] for k in ("fwd", "dw"))
    want += sum(work.conv_call(k, 200, 10, 8, 8)[0]
                for k in ("fwd", "dw", "dx"))
    assert ops1 == want
    assert work.least_seconds(989.4e12, 0) == pytest.approx(1.0)
