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
``impl='reference'`` runs the dense executable spec (ops/reference.py);
``impl='spatial[:axis[:strategy]]'`` shards the point dim of a
self-convolution over the ``axis`` process group of ``mesh``
(parallel/spatial.py, gather or ring).  ``subblock=S`` comes before the
impl dispatch: S small problems of gathered candidates against their own
centers, through either impl, or the plain conv when a group overflows
its slots (``_subblock_conv``).

External counts: ``ext_counts=`` divides by counts taken over a larger
candidate set (``pointwise_conv_counts``), which makes the op linear in the
candidates: its outputs over disjoint candidate subsets sum to the full
convolution (the ring strategy).

Gradient: ``PointwiseConvFunction``, a ``torch.autograd.Function`` whose
forward is ``conv_fwd``'s means walk and product and whose backward is
``conv_dw_product`` over the forward's own cell means (weights),
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
    COUNTERS,
    N_CELLS,
    SENTINEL,
    TILE,
    _SENTINEL_CUT,
    conv_counts,
    conv_dw,
    conv_dw_product,
    conv_dx,
    conv_fwd_means,
    conv_fwd_product,
    count_sync,
    round_up,
    tile_adjacency,
)
from pointwise_torch.ops import reference as _ref

# Where the weight gradients took their cell means (``conv_backward``):
# ``kept`` those that read the forward's own xbar (``PointwiseConvFunction``,
# no walk), ``walked`` those that walked the neighbourhood again
# (``conv_dw``: the ring strategy's partials).  Zeroed by the kernels'
# ``reset_launches`` with the launch counts; not a launch count itself.
DW_XBAR = {"kept": 0, "walked": 0}
COUNTERS.append(DW_XBAR)

# The candidate walk switches to the bbox tile lists once it spans at least
# this many 512-point tiles (the JAX op's rule, ops/pointwise_conv.py:429-430
# there), so the two walk modes serve the same problem sizes as on the TPU.
_CSR_MIN_TILES = 8
_CSR_TILE_POINTS = 512
# A sub-block's candidate slots round up to the JAX op's lane width, so the
# two ops take the same branch on the same inputs.
_SUBBLOCK_ROUND = 128


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
        count_sync("check_coordinates")
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


def conv_backward(g, feats, w, ctr, pts, cnt, radius, tile_ptr, tile_idx,
                  need_feats: bool, need_w: bool, xbar=None):
    """The gradients of one ``conv_fwd`` call, as the TPU op's ``_pw_bwd``
    forms them: (dX (B, Mp, Cin) in the features' matmul type or None,
    dW (27, Cin, Cout) f32 or None).  ``g`` (B, Ncp, Cout) f32; ``cnt`` the
    counts the forward divided by; ``xbar`` the forward's cell means
    (``conv_fwd_means``' view) or None; the rest as the forward took them.
    dW is ``conv_dw_product`` over ``xbar`` when it is given, else
    ``conv_dw``, which walks the neighbourhood again for the same means
    (``DW_XBAR`` counts which)."""
    d_feats = d_w = None
    if need_w:
        if xbar is None:
            DW_XBAR["walked"] += 1
            d_w = conv_dw(ctr, pts, feats, g, cnt, radius, tile_ptr,
                          tile_idx)
        else:
            DW_XBAR["kept"] += 1
            d_w = conv_dw_product(xbar, g.view(-1, g.shape[-1]))
    if need_feats:
        ptr_t = idx_t = None
        if tile_ptr is not None:         # candidate tile -> center tiles
            ptr_t, idx_t = tile_adjacency(pts, ctr, radius)
        d_feats = conv_dx(ctr, pts, g, cnt, w, radius, ptr_t,
                          idx_t).to(feats.dtype)
    return d_feats, d_w


class PointwiseConvFunction(torch.autograd.Function):
    """conv_fwd with the TPU op's gradient (its ``_pw_bwd``, and with
    external counts its ``_pw_ext_bwd``).

    When the weights' gradient will be taken (``needs_input_grad[1]``) the
    forward keeps its cell means ``xbar`` (B*Ncp x 27*Cin in the matmul
    type) for the backward, whose dW is then ``conv_dw_product`` alone: dW's
    own walk would give the same means bit for bit.  Under ``no_grad``,
    ``inference_mode`` or with frozen weights nothing more is kept.  Under
    remat (non-reentrant ``checkpoint``) the first pass's saved tensors are
    dropped by checkpoint's hooks and the forward recomputed in the
    backward keeps ``xbar`` for its own block's backward only.

    apply(feats, weights, bias, ctr, pts, radius, tile_ptr, tile_idx
    [, cnt_in]) -> (y, cnt): ``feats`` padded in the matmul type,
    ``weights`` (27, Cin, Cout) in any float type (cast to the matmul type
    inside), ``bias`` f32, ``cnt_in`` the padded external counts or None;
    the rest as conv_layout builds them.  ``cnt`` is the walk's own counts
    and carries no gradient; the backward divides by ``cnt_in`` when given,
    as the forward did."""

    @staticmethod
    def forward(ctx, feats, weights, bias, ctr, pts, radius, tile_ptr,
                tile_idx, cnt_in=None):
        w = weights.to(feats.dtype).contiguous()
        xbar, cnt = conv_fwd_means(ctr, pts, feats, radius, tile_ptr,
                                   tile_idx, cnt_in)
        y = conv_fwd_product(xbar, w, bias).view(*ctr.shape[:2], w.shape[2])
        ctx.mark_non_differentiable(cnt)
        kept = (xbar,) if ctx.needs_input_grad[1] else ()
        ctx.save_for_backward(feats, w, ctr, pts,
                              cnt if cnt_in is None else cnt_in, tile_ptr,
                              tile_idx, *kept)
        ctx.radius = radius
        ctx.weights_dtype = weights.dtype
        return y, cnt

    @staticmethod
    def backward(ctx, g, _g_cnt):
        feats, w, ctr, pts, div, tile_ptr, tile_idx, *kept = \
            ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        d_feats, d_w = conv_backward(
            g, feats, w, ctr, pts, div, ctx.radius, tile_ptr, tile_idx,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1], *kept)
        if d_w is not None:
            d_w = d_w.to(ctx.weights_dtype)
        d_bias = g.sum(dim=(0, 1)) if ctx.needs_input_grad[2] else None
        return d_feats, d_w, d_bias, None, None, None, None, None, None


def _subblock_conv(points, features, weights, bias, *, radius, mask, n_sub,
                   cap, **common):
    """Exact sub-block overlap-save self-convolution (a port of the JAX
    op's ``_subblock_conv``).

    Centers are ``n_sub`` consecutive groups of the input order; each
    group's candidates are the valid points inside its bbox + radius,
    gathered in input order into ``cap`` slots.  A center lies inside its
    own group's bbox, so its neighborhood is whole whenever the group's
    count fits the cap; otherwise the call takes the plain conv.  Exact
    either way.  Gradients reach ``features`` through the gather (autograd
    of advanced indexing scatter-adds the candidates' cotangents)."""
    batched = points.ndim == 3
    if not batched:
        points, features = points[None], features[None]
        mask = None if mask is None else mask[None]
    B, N, _ = points.shape
    S = n_sub
    if N % S:
        raise ValueError(f"subblock={S} must divide N={N}")
    ns = N // S
    if cap is None:
        # 3x the group size covers a compact morton group and its halo at
        # the radii this path is for; larger radii take the plain conv
        cap = min(N, 3 * ns)
    cap = int(min(round_up(cap, _SUBBLOCK_ROUND), N))
    valid = (torch.ones((B, N), dtype=torch.bool, device=points.device)
             if mask is None else mask.bool())
    p = points.float()
    pg, vg = p.reshape(B, S, ns, 3), valid.reshape(B, S, ns)
    lo = torch.where(vg[..., None], pg, 1.0e9).amin(dim=2) - radius
    hi = torch.where(vg[..., None], pg, -1.0e9).amax(dim=2) + radius
    inb = ((p[:, None] >= lo[:, :, None]) & (p[:, None] <= hi[:, :, None])
           ).all(dim=-1) & valid[:, None]                         # (B, S, N)
    # a host branch on one device scalar: this syncs with the device, as
    # the JAX op's lax.cond does not
    count_sync("subblock_cap")
    if int(inb.sum(dim=-1).max()) > cap:
        y = pointwise_conv(points, features, weights, bias, radius=radius,
                           mask=mask, **common)
        return y if batched else y[0]
    # a stable sort keeps the selected candidates in input (morton) order
    idx = torch.argsort((~inb).to(torch.int8), dim=-1,
                        stable=True)[..., :cap]
    sel_valid = torch.gather(inb, -1, idx)                        # (B, S, cap)
    brow = torch.arange(B, device=points.device)[:, None, None]
    y = pointwise_conv(
        p[brow, idx].reshape(B * S, cap, 3),
        features[brow, idx].reshape(B * S, cap, features.shape[-1]),
        weights, bias, radius=radius,
        mask=sel_valid.reshape(B * S, cap).float(),
        centers=pg.reshape(B * S, ns, 3),
        center_mask=vg.reshape(B * S, ns).float(), **common)
    y = y.reshape(B, N, y.shape[-1])
    return y if batched else y[0]


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
    mesh=None,
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
        for CPU tensors) | 'reference' (the dense executable spec) |
        'spatial[:axis[:strategy]]' (the point dim sharded over ``mesh``'s
        ``axis`` group, default 'space'; strategy 'gather' or 'ring').
      precision: 'float32' | 'bfloat16' matmul inputs (f32 accumulation).
      csr: force (True) or disable (False) the bbox tile-list walk; None
        takes it from 8 walk tiles of 512 candidates up.
      validate: refuse real coordinates that collide with the sentinel
        padding (|x| >= 5e5) instead of silently dropping them.
      ext_counts: optional (Nc, 27) / (B, Nc, 27) EXTERNAL divisor counts
        (``pointwise_conv_counts`` over a larger candidate set): the op
        then computes a partial convolution, linear in the candidates, and
        needs ``bias=None`` (a bias inside each partial would be summed
        once per subset).
      subblock: optional int > 1, exact sub-block overlap-save for small
        radii (self-convolution only): the cloud, morton-sorted by the
        caller, splits into this many consecutive center groups, and each
        group convolves against only the points inside its bbox + radius,
        gathered into ``subblock_cap`` slots (``_subblock_conv``).
      subblock_cap: candidate slots per sub-block, rounded up to 128;
        None = 3x the group size.  The cap picks the branch (a group that
        overflows it sends the call to the plain conv), never the answer.
      mesh: the parallel.mesh.Mesh of a spatial impl.

    Returns:
      (Nc, Cout) or (B, Nc, Cout), in the features' dtype.  Differentiable
      in features, weights and bias (``PointwiseConvFunction``).
    """
    if ext_counts is not None and bias is not None:
        raise ValueError(
            "ext_counts computes a partial convolution — pass bias=None and "
            "add the bias once after summing the partials")
    if impl.startswith("spatial"):
        # 'spatial' or 'spatial:<axis>[:<strategy>]': the point dim sharded
        # over a process group of the current mesh.  Lazy import: the
        # parallel package imports this module.
        from pointwise_torch.parallel.spatial import spatial_pointwise_conv

        parts = impl.split(":")
        axis = parts[1] if len(parts) > 1 and parts[1] else "space"
        strategy = parts[2] if len(parts) > 2 else "gather"
        if centers is not None:
            raise ValueError("spatial impl shards self-convolution only")
        dropped = {"center_mask": center_mask, "ext_counts": ext_counts,
                   "csr": csr, "subblock": subblock,
                   "subblock_cap": subblock_cap, "validate": validate or None}
        bad = sorted(k for k, v in dropped.items() if v is not None)
        if bad:
            raise ValueError(f"spatial impl does not support {bad}")
        return spatial_pointwise_conv(
            points, features, weights, bias, radius=radius,
            group=None if mesh is None else mesh.group(axis),
            mask_local=mask, strategy=strategy, precision=precision)
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl: {impl!r}")
    if subblock is not None and subblock > 1:
        # before the impl dispatch, and impl forwarded into the recursion,
        # so that impl='reference' checks the gather and the fallback
        # against the executable spec
        if centers is not None or ext_counts is not None:
            raise ValueError("subblock supports self-convolution only")
        return _subblock_conv(
            points, features, weights, bias, radius=radius, mask=mask,
            n_sub=int(subblock), cap=subblock_cap, impl=impl,
            precision=precision, csr=csr, validate=validate)
    if validate:
        _check_coordinates(points, mask, centers, center_mask)
    if impl == "reference":
        return _ref.pointwise_conv_reference(
            points, features, weights, bias, radius=radius, mask=mask,
            centers=centers, center_mask=center_mask, ext_counts=ext_counts)

    kw, (batched, Nc, center_mask) = conv_layout(
        points, features, weights, bias, radius=radius, mask=mask,
        centers=centers, center_mask=center_mask, precision=precision,
        csr=csr)
    cnt_in = None
    if ext_counts is not None:
        cnt_in = pad_counts(ext_counts if batched else ext_counts[None],
                            kw["ctr"].shape[1])
    # the f32 weights, not kw["w"]: the Function casts inside, so that dW
    # is the gradient of the f32 weights
    y, _ = PointwiseConvFunction.apply(
        kw["feats"], weights, kw["bias"], kw["ctr"], kw["pts"], kw["radius"],
        kw["tile_ptr"], kw["tile_idx"], cnt_in)
    y = y[:, :Nc].to(features.dtype)
    if center_mask is not None:
        y = y * center_mask.to(y.dtype)[..., None]
    return y if batched else y[0]


def pad_counts(counts, ncp: int):
    """(B, Nc, 27) counts as the kernels' f32 (B, Ncp, 27), zero padded."""
    counts = counts.detach().to(torch.float32)
    return torch.nn.functional.pad(
        counts, (0, 0, 0, ncp - counts.shape[1])).contiguous()


def pointwise_conv_counts(
    points: torch.Tensor,
    *,
    radius: float,
    mask: torch.Tensor | None = None,
    centers: torch.Tensor | None = None,
    center_mask: torch.Tensor | None = None,
    csr: bool | None = None,
) -> torch.Tensor:
    """Per-cell neighbor counts (Nc, 27) or (B, Nc, 27) f32: geometry only,
    no features (the ring strategy's pre-pass; a port of the JAX op's
    ``pointwise_conv_counts``).

    The same layout as ``pointwise_conv`` (``_geometry_layout``) and the
    same walk rule (``csr``), so the counts equal the conv's own.  Counts
    are piecewise constant in the positions and carry no gradient."""
    (batched, B, M, Nc, Mp, Ncp, pts, ctr,
     _) = _geometry_layout(points, mask, centers, center_mask)
    tile_ptr = tile_idx = None
    if csr_walk(M, csr):
        tile_ptr, tile_idx = tile_adjacency(ctr, pts, radius)
    counts = conv_counts(ctr, pts, float(radius), tile_ptr,
                         tile_idx)[:, :Nc].detach()
    return counts if batched else counts[0]
