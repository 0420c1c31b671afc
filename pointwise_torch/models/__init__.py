from pointwise_torch.models.classifier import (  # noqa: F401
    PointwiseClassifier,
    classification_loss,
    classification_loss_sums,
)
from pointwise_torch.models.layers import (  # noqa: F401
    MaskedBatchNorm,
    PointwiseConv,
    PointwiseConvBlock,
    masked_pool,
)
from pointwise_torch.models.segmenter import (  # noqa: F401
    PointwiseSegmenter,
    ShapeNetPartSegmenter,
    segmentation_loss,
    segmentation_loss_sums,
)
