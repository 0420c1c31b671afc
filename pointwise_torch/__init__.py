"""pointwise_torch — the PyTorch / CUDA port of pointwise_tpu.

Same module names as the JAX package, PyTorch idiom inside: ``nn.Module``s,
explicit ``device``, explicit ``torch.Generator``.  The pointwise conv runs
in a hand-written Hopper kernel (kernels/csrc/) on CUDA tensors and in its
plain PyTorch version on CPU tensors.  The package imports nothing of JAX
or of ``pointwise_tpu``.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; with no
card they raise rather than fall back (``resolve_device``).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    the CPU.  Raises when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) to "
            "run the plain PyTorch path on the CPU")
    return dev
