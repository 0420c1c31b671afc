"""Data and spatial parallelism on ``torch.distributed`` (a port of
pointwise_tpu/parallel).  ``spmd`` (the sums-contract loss functions) and
``launch`` (spawned ranks) are imported by name."""

from pointwise_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
)
from pointwise_torch.parallel.spatial import spatial_pointwise_conv  # noqa: F401
