from pointwise_torch.ops.pointwise_conv import (  # noqa: F401
    pointwise_conv,
    pointwise_conv_counts,
)
from pointwise_torch.ops.reference import pointwise_conv_reference  # noqa: F401
