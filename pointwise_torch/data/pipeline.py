"""Host -> device input pipeline: batches staged ahead of the step.

A port of pointwise_tpu/data/pipeline.py.  On a CUDA device each numpy
batch is copied into pinned host memory and sent with a non-blocking copy
on the current stream, ``size`` batches ahead of the step that consumes it,
so the host builds and ships batch k+1 while the device runs step k.  On
the CPU the arrays are only wrapped as tensors.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch


def to_device(batch: dict, device: torch.device) -> dict:
    """{name: numpy array} -> {name: tensor on ``device``}."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(it: Iterable[dict], device: torch.device,
                       size: int = 2) -> Iterator[dict]:
    """Yield the batches of ``it`` on ``device``, ``size`` staged ahead."""
    queue = collections.deque()
    it = iter(it)
    for batch in itertools.islice(it, size):
        queue.append(to_device(batch, device))
    while queue:
        yield queue.popleft()
        for batch in itertools.islice(it, 1):
            queue.append(to_device(batch, device))
