from pointwise_torch.data import synthetic  # noqa: F401
