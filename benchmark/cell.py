"""Finding a cell's configuration, traffic and limits by name, and the
program's configuration object built from the benchmark's file."""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(bench: dict, workload: str):
    """(cell, configuration entry) of ``workload``; KeyError when the
    benchmark has no such cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def load_json(root: str, path: str) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def load_limits(workload: str) -> dict:
    """{compared number: limit} of a cell (benchmark/limits/<cell>.json)."""
    return load_json(HERE, os.path.join("limits", f"{workload}.json"))["limits"]


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones without ``trace``, the per-layer ones with it; a metric with a
    ``workloads`` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def port_config(cfg: dict):
    """The program's configuration object for the benchmark's ``cfg``."""
    from pointwise_torch.train.configs import (ClassificationConfig,
                                               OptimizerConfig,
                                               SegmentationConfig)

    common = dict(name=cfg["name"], num_points=cfg["num_points"],
                  batch_size=cfg["batch_size"],
                  num_classes=cfg["num_classes"],
                  channels=tuple(cfg["channels"]),
                  radii=tuple(cfg["radii"]),
                  head_dims=tuple(cfg["head_dims"]),
                  dropout=cfg["dropout"], norm=cfg["norm"],
                  optimizer=OptimizerConfig(**cfg["optimizer"]))
    if cfg["net"] == "classifier":
        return ClassificationConfig(rotate_augment=cfg["rotate_augment"],
                                    **common)
    return SegmentationConfig(in_features=cfg["in_features"],
                              global_context=cfg["global_context"],
                              block_size=cfg["block_size"],
                              block_stride=cfg["block_stride"], **common)
