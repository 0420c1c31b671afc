"""Shared fixtures of the benchmark's CPU tests: the repository root on
``sys.path`` and tiny procedural rooms in place of the cells' full-size
ones (the cells' own sizes run only on the card)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def tiny_rooms(monkeypatch):
    """Rooms of a few hundred points for every traffic mix."""
    import torch

    from benchmark import traffic
    from benchmark.frozen import synthetic

    torch.set_num_threads(4)

    def small(n_points, seed=0, num_classes=5):
        return synthetic.segmentation_scene(
            seed, num_objects=2, points_per_obj=320, room=1.5,
            num_classes=num_classes)

    monkeypatch.setattr(traffic.synthetic, "big_scene", small)


# the cells at sizes the CPU runs in seconds, every width as configured
SMALL = {
    "s3dis_seg.serve_scans_200k": (None, {"tile_size": 1.0, "base_scenes": 2,
                                          "check_scans": 1,
                                          "profile_scans": 1}),
    "s3dis_seg.serve_rooms_1m": (None, {"tile_size": 1.0, "base_scenes": 1,
                                        "check_scans": 1,
                                        "profile_scans": 1}),
    "s3dis_seg.train_blocks": ({"batch_size": 2, "num_points": 256},
                               {"pool_batches": 3, "profile_steps": 1}),
    "modelnet40_cls.train": ({"batch_size": 4, "num_points": 128},
                             {"pool_batches": 3, "profile_steps": 1}),
}


def run_small(workload, seed=2 ** 31 + 17, trace=False):
    """One CPU run of ``workload`` at its small size."""
    import time

    from benchmark import run

    cfg_update, mix_update = SMALL[workload]
    return run.execute(workload, seed, 0.0, trace, "cpu",
                       t_start=time.perf_counter(), log=lambda s: None,
                       config_update=cfg_update, traffic_update=mix_update)
