"""``python -m pointwise_torch.train`` (see train/cli.py)."""

from pointwise_torch.train.cli import main

main()
