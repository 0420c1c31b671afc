"""ModelNet40 classification dataset.

A port of pointwise_tpu/data/modelnet.py: HDF5 shards of pre-sampled clouds
(datasets ``data`` (B, N, 3) and ``label`` (B, 1), listed in
``{split}_files.txt``) when a directory holds them, the procedural primitive
set otherwise.  Reading the shards needs ``h5py``, which the port does not
require: without it a directory of shards raises.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Iterator

import numpy as np

from pointwise_torch.data import synthetic
from pointwise_torch.utils import spatial


@dataclasses.dataclass
class ClassificationData:
    points: np.ndarray     # (num, N, 3) float32
    labels: np.ndarray     # (num,) int32
    num_classes: int
    name: str = "modelnet40"


def _h5_files(path: str, split: str) -> list:
    list_file = os.path.join(path, f"{split}_files.txt")
    if os.path.exists(list_file):
        with open(list_file) as fh:
            return [os.path.join(path, os.path.basename(line.strip()))
                    for line in fh if line.strip()]
    return sorted(glob.glob(os.path.join(path, f"*{split}*.h5")))


def _load_h5_dir(path: str, split: str) -> ClassificationData | None:
    files = _h5_files(path, split)
    if not files:
        return None
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            f"{path} holds ModelNet40 HDF5 shards but h5py is not installed; "
            "install h5py or omit the data directory (synthetic set)") from e
    pts, labs = [], []
    for f in files:
        with h5py.File(f, "r") as h:
            pts.append(np.asarray(h["data"], np.float32))
            labs.append(np.asarray(h["label"], np.int64).reshape(-1))
    points = spatial.check_coordinates(np.concatenate(pts), name=path)
    labels = np.concatenate(labs).astype(np.int32)
    return ClassificationData(points, labels, int(labels.max()) + 1)


def load_modelnet40(path: str | None = None, split: str = "train",
                    n_points: int = 1024, synthetic_size: int = 512,
                    seed: int = 0, variant: str = "default"
                    ) -> ClassificationData:
    """Real archive if ``path`` has one; procedural primitives otherwise
    (``variant='hard'`` = the deformed set)."""
    if path:
        data = _load_h5_dir(path, split)
        if data is not None:
            if data.points.shape[1] > n_points:
                data.points = data.points[:, :n_points]
            data.points = spatial.morton_sort_batch(data.points)
            return data
    seed = seed + (0 if split == "train" else 10_000)
    pts, labs = synthetic.classification_set(seed, synthetic_size, n_points,
                                             variant=variant)
    pts = spatial.morton_sort_batch(pts)
    return ClassificationData(pts, labs, synthetic.NUM_CLASSES,
                              name="synthetic")


def batches(data: ClassificationData, batch_size: int, *, shuffle=True,
            seed: int = 0, drop_remainder: bool = True) -> Iterator[dict]:
    """Host-side epoch iterator of {'points', 'label'} numpy batches."""
    n = len(data.labels)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, stop, batch_size):
        sel = idx[s:s + batch_size]
        yield {"points": data.points[sel], "label": data.labels[sel]}
