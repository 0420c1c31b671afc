"""Typed workload configs (SURVEY.md section 5 'Config / flags').

A copy of pointwise_tpu/train/configs.py: the PyTorch port keeps its own
copy so that it imports nothing of the JAX package.

The reference exposes argparse flags per train script; here each
BASELINE.json config entry is a frozen dataclass.  Everything is hashable on
purpose: a config can be part of a jit cache key.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 200
    decay_steps: int = 20_000
    min_lr_ratio: float = 0.01
    grad_clip: float = 5.0
    b1: float = 0.9
    b2: float = 0.999


@dataclasses.dataclass(frozen=True)
class ClassificationConfig:
    name: str = "modelnet40"
    data_dir: str | None = None
    num_points: int = 1024
    batch_size: int = 32
    num_classes: int = 40
    # all-124 trunk: lane-filling at zero time cost (GOLDEN round 4)
    channels: Tuple[int, ...] = (124, 124, 124, 124)
    radii: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
    head_dims: Tuple[int, ...] = (256, 128)
    dropout: float = 0.3
    norm: str = "layer"
    impl: str = "auto"
    epochs: int = 100
    rotate_augment: bool = True
    variant: str = "default"        # synthetic-set variant ('hard' = deformed)
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    eval_every: int = 500
    log_every: int = 50


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    name: str = "s3dis"
    data_dir: str | None = None
    num_points: int = 4096          # points per block (S3DIS sliding blocks)
    batch_size: int = 16
    num_classes: int = 13
    in_features: int = 6            # rgb + normalized room coords, set per dataset
    # all-124 trunk: lane-filling at zero time cost (GOLDEN round 4)
    channels: Tuple[int, ...] = (124, 124, 124, 124)
    radii: Tuple[float, ...] = (0.1, 0.2, 0.4, 0.8)
    head_dims: Tuple[int, ...] = (256, 128)
    dropout: float = 0.3
    norm: str = "layer"
    impl: str = "auto"
    global_context: bool = True   # False => locality-only (exact streaming)
    variant: str = "default"        # synthetic-set variant ('hard' = deformed)
    epochs: int = 50
    block_size: float = 1.0         # meters, sliding-block crop
    block_stride: float = 0.5       # training stride; eval overlaps for voting
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    eval_every: int = 500
    log_every: int = 50


_REGISTRY = {
    "modelnet40": ClassificationConfig(),
    "modelnet40_synthetic": ClassificationConfig(
        name="modelnet40_synthetic", num_classes=10, epochs=30
    ),
    # harder procedural anchor: anisotropic scaling + SO(3) rotation +
    # jitter + outliers keep accuracy off the 1.000 ceiling so the pinned
    # number can regress (GOLDEN.md)
    "cls_synthetic_hard": ClassificationConfig(
        name="cls_synthetic_hard", num_classes=10, epochs=30, variant="hard"
    ),
    "scenenn": SegmentationConfig(
        name="scenenn", num_classes=40, in_features=3, block_size=1.5
    ),
    # locality-only SceneNN (exact streaming eval/serving needs
    # use_global_context=False — same pattern as s3dis_synthetic_local)
    "scenenn_local": SegmentationConfig(
        name="scenenn_local", num_classes=40, in_features=3,
        block_size=1.5, global_context=False,
    ),
    # tiny SceneNN config (CI: the 40-way NYU head trains/evals end-to-end
    # on the CPU backend against the procedural scenenn_scene stand-in)
    "scenenn_tiny": SegmentationConfig(
        name="scenenn_tiny", num_classes=40, in_features=3, num_points=256,
        batch_size=4, block_size=1.5, channels=(16, 16), radii=(0.3, 0.6),
        head_dims=(32,), impl="reference", global_context=False,
        log_every=1, eval_every=10_000, checkpoint_every=10_000,
    ),
    "s3dis": SegmentationConfig(name="s3dis"),
    "s3dis_synthetic": SegmentationConfig(
        name="s3dis_synthetic", num_classes=5, batch_size=8
    ),
    "s3dis_synthetic_local": SegmentationConfig(
        name="s3dis_synthetic_local", num_classes=5, batch_size=8,
        global_context=False,
    ),
    # tiny smoke config (CI / CPU-mesh SPMD runs)
    "seg_tiny_local": SegmentationConfig(
        name="seg_tiny_local", num_classes=5, batch_size=4, num_points=256,
        global_context=False, log_every=1, eval_every=10_000,
    ),
    # tiny locality-only streaming config (CI: infer --serve subprocess runs
    # on the CPU backend — reference impl + 8-wide trunk keep compiles fast)
    "seg_tiny_stream": SegmentationConfig(
        name="seg_tiny_stream", num_classes=5, batch_size=2, num_points=256,
        channels=(8, 8), radii=(0.25, 0.5), head_dims=(16,), dropout=0.0,
        impl="reference", global_context=False,
        log_every=1, eval_every=10_000, checkpoint_every=10_000,
    ),
    # tiny classification config (CI: CLI resume/metric determinism runs)
    "cls_tiny": ClassificationConfig(
        name="cls_tiny", num_classes=4, num_points=64, batch_size=8,
        channels=(8, 8), radii=(0.5, 1.0), head_dims=(16,),
        epochs=2, log_every=1, eval_every=10_000, checkpoint_every=10_000,
    ),
    # Deep conv stack with growing-but-local radii: receptive field reaches
    # the whole (unit-sphere) object through stacking, not through O(N^2)
    # global supports — the accelerator-friendly way to go deep.
    "shapenetpart": SegmentationConfig(
        name="shapenetpart",
        num_classes=50,
        num_points=2048,
        batch_size=8,
        in_features=3,
        channels=(124, 124, 124, 124, 124, 124),
        radii=(0.1, 0.15, 0.2, 0.3, 0.4, 0.6),
    ),
    # tiny part-seg config (CI: CLI smoke runs on the CPU backend)
    "shapenetpart_tiny": SegmentationConfig(
        name="shapenetpart_tiny", num_classes=50, num_points=128,
        batch_size=2, in_features=3, channels=(8, 8), radii=(0.3, 0.5),
        head_dims=(16,), impl="reference",
        log_every=1, eval_every=10_000, checkpoint_every=10_000,
    ),
    # hard part-seg anchor: canonical-geometry part labels + deformed
    # clouds (see shapenetpart.synthetic_set variant='hard') so the pinned
    # number sits off the ceiling and can regress (VERDICT r3 #8)
    "shapenetpart_hard": SegmentationConfig(
        name="shapenetpart_hard",
        num_classes=50,
        num_points=2048,
        batch_size=8,
        in_features=3,
        channels=(124, 124, 124, 124, 124, 124),
        radii=(0.1, 0.15, 0.2, 0.3, 0.4, 0.6),
        variant="hard",
    ),
}


def get_config(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
