"""The precision control: the reference in a narrower type than the
configuration states.  The configurations state bfloat16 for the conv
matmuls; the next narrower type is fp8 (e4m3), here with one scale per
tensor that maps its largest magnitude to the type's largest value, as an
fp8 path with per-tensor scaling would."""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one per-tensor scale, back in f32."""
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
