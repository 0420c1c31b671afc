from pointwise_torch.train.configs import (  # noqa: F401
    ClassificationConfig,
    SegmentationConfig,
    get_config,
)
