from pointwise_torch.models.layers import (  # noqa: F401
    MaskedBatchNorm,
    PointwiseConv,
    PointwiseConvBlock,
    masked_pool,
)
from pointwise_torch.models.segmenter import PointwiseSegmenter  # noqa: F401
