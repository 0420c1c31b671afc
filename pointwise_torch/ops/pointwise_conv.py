"""Public pointwise-convolution op: padding, layout, dispatch, gradient.

A port of pointwise_tpu/ops/pointwise_conv.py and of the custom VJP of
``pointwise_conv_pallas`` (kernels/pointwise_conv_pallas.py there).  The
wrapper turns the user-facing irregular problem into the padded layout the
kernel wants:
  * centers and candidates are padded to multiples of the kernel's tile
    (``TILE`` points); padding points sit at a far SENTINEL coordinate so
    they fall outside every neighborhood (no in-kernel masking needed);
  * masked (invalid) candidates are likewise moved to +SENTINEL, masked
    non-self centers to -SENTINEL; self-conv centers keep their coordinates
    and masked ones are zeroed by the final center-mask multiply, exactly
    like the reference;
  * features and weights travel in the matmul type (``precision``).

Dispatch: ``impl='auto'`` runs the Hopper kernels for CUDA tensors and
their plain PyTorch versions for CPU tensors (kernels/pointwise_conv_cuda.py);
``impl='reference'`` runs the dense executable spec (ops/reference.py).

Gradient: ``PointwiseConvFunction``, a ``torch.autograd.Function`` whose
forward is ``conv_fwd`` and whose backward is ``conv_dw`` (weights),
``conv_dx`` (features, skipped when they need no gradient) and ``g.sum``
(bias), on either device.  It rounds where the TPU op's ``_pw_bwd`` does:
it takes the f32 weights and casts them to the matmul type inside, so dW is
the f32 gradient of the f32 weights; dX comes back in the features' matmul
type, which the caller casts from outside the Function (as the JAX op casts
the features outside its custom VJP).
"""

from __future__ import annotations

import torch

from pointwise_torch.kernels.pointwise_conv_cuda import (
    N_CELLS,
    SENTINEL,
    TILE,
    _SENTINEL_CUT,
    conv_dw,
    conv_dx,
    conv_fwd,
    round_up,
    tile_adjacency,
)
from pointwise_torch.ops import reference as _ref

# The candidate walk switches to the bbox tile lists once it spans at least
# this many 512-point tiles (the JAX op's rule, ops/pointwise_conv.py:429-430
# there), so the two walk modes serve the same problem sizes as on the TPU.
_CSR_MIN_TILES = 8
_CSR_TILE_POINTS = 512


def csr_walk(n_candidates: int, csr: bool | None = None) -> bool:
    """Whether the forward walks bbox tile lists (True) or every tile."""
    if csr is not None:
        return bool(csr)
    return -(-n_candidates // _CSR_TILE_POINTS) >= _CSR_MIN_TILES


def _geometry_layout(points, mask, centers, center_mask):
    """Batch-dim promotion, self-conv center defaulting (``center_mask``
    defaults to ``mask`` ONLY when not given, as in ops/reference.py),
    sentinel moves and padding to multiples of TILE.

    Returns (batched, B, M, Nc, Mp, Ncp, pts, ctr, center_mask) with
    pts (B, Mp, 3) / ctr (B, Ncp, 3) f32, sentinel-moved and padded.
    """
    batched = points.ndim == 3
    if not batched:
        points = points[None]
        mask = None if mask is None else mask[None]
        centers = None if centers is None else centers[None]
        center_mask = None if center_mask is None else center_mask[None]
    self_conv = centers is None
    if self_conv:
        centers = points
        if center_mask is None:
            center_mask = mask

    B, M, _ = points.shape
    Nc = centers.shape[1]
    Mp = round_up(max(M, 1), TILE)
    Ncp = round_up(max(Nc, 1), TILE)
    f32 = torch.float32
    pts = points.to(f32)
    if mask is not None:
        pts = torch.where(mask.bool()[..., None], pts, SENTINEL)
    pts = torch.nn.functional.pad(pts, (0, 0, 0, Mp - M), value=SENTINEL)
    ctr = centers.to(f32)
    if (not self_conv) and center_mask is not None:
        ctr = torch.where(center_mask.bool()[..., None], ctr, -SENTINEL)
    ctr = torch.nn.functional.pad(ctr, (0, 0, 0, Ncp - Nc), value=-SENTINEL)
    return (batched, B, M, Nc, Mp, Ncp, pts.contiguous(), ctr.contiguous(),
            center_mask)


def _check_coordinates(points, mask, centers, center_mask):
    """Coordinates at |x| >= _SENTINEL_CUT are indistinguishable from
    padding (their neighborhoods silently drop): refuse them."""
    for name, p, m in (("", points, mask), ("CENTER ", centers, center_mask)):
        if p is None:
            continue
        real = p.float() if m is None else torch.where(
            m.bool()[..., None], p.float(), 0.0)
        if not bool(torch.all(torch.abs(real) < _SENTINEL_CUT)):
            raise ValueError(
                f"pointwise_conv: real (unmasked) {name}coordinates must "
                "satisfy |x| < 5e5 — larger values collide with the sentinel "
                "padding and their neighborhoods are silently dropped; "
                "normalize/recenter the cloud.")


def conv_layout(points, features, weights, bias=None, *, radius,
                mask=None, centers=None, center_mask=None,
                precision="float32", csr=None):
    """Padded kernel inputs for one conv call, exactly as ``pointwise_conv``
    builds them: returns (kernel kwargs, (batched, Nc, center_mask)).

    The kwargs are ctr, pts, feats, w, bias, radius, tile_ptr, tile_idx —
    the contract of kernels.pointwise_conv_cuda.conv_fwd (tile_ptr/tile_idx
    None for the dense walk; feats and w in the matmul type)."""
    Cin = features.shape[-1]
    Cout = weights.shape[-1]
    if weights.shape != (N_CELLS, Cin, Cout):
        raise ValueError(
            f"weights must be (27, {Cin}, Cout), got {tuple(weights.shape)}")
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"unknown precision: {precision!r}")
    (batched, B, M, Nc, Mp, Ncp, pts, ctr,
     center_mask) = _geometry_layout(points, mask, centers, center_mask)
    if not batched:
        features = features[None]
    mm = torch.bfloat16 if precision == "bfloat16" else torch.float32
    feats = torch.nn.functional.pad(features.to(mm), (0, 0, 0, Mp - M))
    b = (torch.zeros((Cout,), dtype=torch.float32, device=pts.device)
         if bias is None else bias.to(torch.float32))
    tile_ptr = tile_idx = None
    if csr_walk(M, csr):
        tile_ptr, tile_idx = tile_adjacency(ctr, pts, radius)
    kw = dict(ctr=ctr, pts=pts, feats=feats.contiguous(),
              w=weights.to(mm).contiguous(), bias=b.contiguous(),
              radius=float(radius), tile_ptr=tile_ptr, tile_idx=tile_idx)
    return kw, (batched, Nc, center_mask)


class PointwiseConvFunction(torch.autograd.Function):
    """conv_fwd with the TPU op's gradient (its ``_pw_bwd``).

    apply(feats, weights, bias, ctr, pts, radius, tile_ptr, tile_idx) ->
    (y, cnt): ``feats`` padded in the matmul type, ``weights`` (27, Cin,
    Cout) in any float type (cast to the matmul type inside), ``bias`` f32;
    the rest as conv_layout builds them.  The counts carry no gradient."""

    @staticmethod
    def forward(ctx, feats, weights, bias, ctr, pts, radius, tile_ptr,
                tile_idx):
        w = weights.to(feats.dtype).contiguous()
        y, cnt = conv_fwd(ctr, pts, feats, w, bias, radius, tile_ptr,
                          tile_idx)
        ctx.mark_non_differentiable(cnt)
        ctx.save_for_backward(feats, w, ctr, pts, cnt, tile_ptr, tile_idx)
        ctx.radius = radius
        ctx.weights_dtype = weights.dtype
        return y, cnt

    @staticmethod
    def backward(ctx, g, _g_cnt):
        feats, w, ctr, pts, cnt, tile_ptr, tile_idx = ctx.saved_tensors
        r = ctx.radius
        g = g.to(torch.float32).contiguous()
        d_feats = d_w = d_bias = None
        if ctx.needs_input_grad[1]:
            d_w = conv_dw(ctr, pts, feats, g, cnt, r, tile_ptr,
                          tile_idx).to(ctx.weights_dtype)
        if ctx.needs_input_grad[0]:
            ptr_t = idx_t = None
            if tile_ptr is not None:     # candidate tile -> center tiles
                ptr_t, idx_t = tile_adjacency(pts, ctr, r)
            d_feats = conv_dx(ctr, pts, g, cnt, w, r, ptr_t,
                              idx_t).to(feats.dtype)
        if ctx.needs_input_grad[2]:
            d_bias = g.sum(dim=(0, 1))
        return d_feats, d_w, d_bias, None, None, None, None, None


def pointwise_conv(
    points: torch.Tensor,
    features: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    radius: float,
    mask: torch.Tensor | None = None,
    centers: torch.Tensor | None = None,
    center_mask: torch.Tensor | None = None,
    impl: str = "auto",
    precision: str = "float32",
    csr: bool | None = None,
    validate: bool = False,
    ext_counts: torch.Tensor | None = None,
    subblock: int | None = None,
    subblock_cap: int | None = None,
) -> torch.Tensor:
    """Pointwise convolution (see ops/reference.py for exact semantics).

    Args:
      points: (M, 3) or (B, M, 3) candidate positions.
      features: (M, Cin) or (B, M, Cin) candidate features.
      weights: (27, Cin, Cout).
      bias: optional (Cout,).
      radius: kernel radius.
      mask: optional candidate validity (0 = padding slot).
      centers: optional distinct conv centers (defaults to ``points``).
      center_mask: optional center validity; invalid centers output zeros.
      impl: 'auto' (the Hopper kernel for CUDA tensors, its plain version
        for CPU tensors) | 'reference' (the dense executable spec).
      precision: 'float32' | 'bfloat16' matmul inputs (f32 accumulation).
      csr: force (True) or disable (False) the bbox tile-list walk; None
        takes it from 8 walk tiles of 512 candidates up.
      validate: refuse real coordinates that collide with the sentinel
        padding (|x| >= 5e5) instead of silently dropping them.
      ext_counts, subblock, subblock_cap: not yet ported (they raise).

    Returns:
      (Nc, Cout) or (B, Nc, Cout), in the features' dtype.  Differentiable
      in features, weights and bias (``PointwiseConvFunction``).
    """
    if ext_counts is not None:
        raise NotImplementedError("pointwise_conv ext_counts: not yet ported")
    if subblock is not None or subblock_cap is not None:
        raise NotImplementedError("pointwise_conv subblock: not yet ported")
    if impl.startswith("spatial"):
        raise NotImplementedError(f"pointwise_conv impl={impl!r}: not yet "
                                  "ported")
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl: {impl!r}")
    if validate:
        _check_coordinates(points, mask, centers, center_mask)
    if impl == "reference":
        return _ref.pointwise_conv_reference(
            points, features, weights, bias, radius=radius, mask=mask,
            centers=centers, center_mask=center_mask)

    kw, (batched, Nc, center_mask) = conv_layout(
        points, features, weights, bias, radius=radius, mask=mask,
        centers=centers, center_mask=center_mask, precision=precision,
        csr=csr)
    # the f32 weights, not kw["w"]: the Function casts inside, so that dW
    # is the gradient of the f32 weights
    y, _ = PointwiseConvFunction.apply(
        kw["feats"], weights, kw["bias"], kw["ctr"], kw["pts"], kw["radius"],
        kw["tile_ptr"], kw["tile_idx"])
    y = y[:, :Nc].to(features.dtype)
    if center_mask is not None:
        y = y * center_mask.to(y.dtype)[..., None]
    return y if batched else y[0]


def pointwise_conv_counts(*args, **kwargs):
    """Per-cell neighbor counts (the ring strategy's pre-pass)."""
    raise NotImplementedError("pointwise_conv_counts: not yet ported")
