"""The CUDA kernels (forward, dW, dX, counts) against their plain PyTorch
versions, on the card.

Marked ``cuda``: the ``cuda`` fixture skips each test when no card is
present (decided inside the fixture, never at import).  On a host with an
NVIDIA Hopper GPU run
``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py`` (the
repository conftest sets JAX up for the CPU tests; these need none of it).
Tolerances: f32 1e-4, relative to max |want| for the gradients (the plain
version sums with atomics in another order); bf16 2e-2 relative to
max |want| (one bf16 ulp of a rounded mean or per-cell sum can flip).  A
product kernel alone, given the same rounded operand as its plain version,
is held to 1e-4 relative to max |want| in both types: only the order of
its f32 sums differs.
"""

import numpy as np
import pytest
import torch

from pointwise_torch.data import synthetic
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.ops.pointwise_conv import conv_layout
from pointwise_torch.utils.spatial import morton_sort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene_inputs(dev, b=2, n=3000, nc=2500, cin=6, cout=124, seed=0):
    rng = np.random.RandomState(seed)
    xyz, _, _ = synthetic.segmentation_scene(seed, num_objects=4,
                                             points_per_obj=1024, room=2.0)
    pts = np.stack([morton_sort(xyz[rng.choice(len(xyz), n, False)])
                    for _ in range(b)])
    ctr = pts[:, :nc]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    return dict(
        points=t(pts), features=t(rng.standard_normal((b, n, cin))),
        weights=t(rng.standard_normal((27, cin, cout)) / np.sqrt(27 * cin)),
        bias=t(rng.standard_normal(cout) * 0.1),
        mask=t(rng.rand(b, n) > 0.1), centers=t(ctr),
        center_mask=t(rng.rand(b, nc) > 0.1))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_kernel_matches_plain(cuda, csr, precision):
    p = _scene_inputs(cuda, cin=6 if precision == "float32" else 124)
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=0.2, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], precision=precision,
                        csr=csr)
    y, cnt = tk.conv_fwd(**kw)
    y_p, cnt_p = tk.conv_fwd_plain(**kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(cnt, cnt_p, rtol=0, atol=0)
    assert cnt.sum() > 0
    if precision == "float32":
        torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    else:
        err = (y - y_p).abs().max() / y_p.abs().max()
        assert err <= 2e-2, float(err)


def test_kernel_deterministic_and_walks_agree(cuda):
    p = _scene_inputs(cuda, cin=124)
    outs = []
    for csr in (False, True, True):
        kw, _ = conv_layout(p["points"], p["features"], p["weights"],
                            p["bias"], radius=0.4, mask=p["mask"], csr=csr)
        outs.append(tk.conv_fwd(**kw)[0])
    assert torch.equal(outs[1], outs[2])      # run to run
    assert torch.equal(outs[0], outs[1])      # dense == CSR, bit for bit


def _grad_inputs(p, radius, precision, csr):
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=radius, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], precision=precision,
                        csr=csr)
    _, cnt = tk.conv_fwd(**kw)
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.standard_normal(
        (kw["ctr"].shape[0], kw["ctr"].shape[1], kw["w"].shape[2])).astype(
        np.float32)).to(cnt.device)
    ptr_t = idx_t = None
    if csr:
        ptr_t, idx_t = tk.tile_adjacency(kw["pts"], kw["ctr"], radius)
    dw_args = (kw["ctr"], kw["pts"], kw["feats"], g, cnt, radius,
               kw["tile_ptr"], kw["tile_idx"])
    dx_args = (kw["ctr"], kw["pts"], g, cnt, kw["w"], radius, ptr_t, idx_t)
    return dw_args, dx_args


def _close(got, want, precision):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = 2e-2 if precision == "bfloat16" else 1e-4
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_grad_kernels_match_plain(cuda, csr, precision):
    p = _scene_inputs(cuda, cin=124)
    dw_args, dx_args = _grad_inputs(p, 0.2, precision, csr)
    dw, dx = tk.conv_dw(*dw_args), tk.conv_dx(*dx_args)
    dw_p, dx_p = tk.conv_dw_plain(*dw_args), tk.conv_dx_plain(*dx_args)
    torch.cuda.synchronize()
    assert dw.shape == dw_p.shape and dx.shape == dx_p.shape
    assert dw.abs().max() > 0 and dx.abs().max() > 0
    _close(dw, dw_p, precision)
    _close(dx, dx_p, precision)


def test_grad_kernels_deterministic_and_walks_agree(cuda):
    p = _scene_inputs(cuda, cin=124)
    outs = []
    for csr in (False, True, True):
        dw_args, dx_args = _grad_inputs(p, 0.4, "bfloat16", csr)
        outs.append((tk.conv_dw(*dw_args), tk.conv_dx(*dx_args)))
    for a, b in zip(outs[1], outs[2]):
        assert torch.equal(a, b)              # run to run
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)              # dense == CSR, bit for bit


def test_launch_counters_and_gradient(cuda):
    p = _scene_inputs(cuda)
    tk.reset_launches()
    with torch.no_grad():
        pointwise_conv(p["points"], p["features"], p["weights"], p["bias"],
                       radius=0.2, csr=False)
        pointwise_conv(p["points"], p["features"], p["weights"], p["bias"],
                       radius=0.2, csr=True)
    # each forward: one means walk of its mode and one product
    assert tk.LAUNCHES == dict(tk.LAUNCHES, fwd_dense=1, fwd_csr=1,
                               fwd_product=2)
    assert sum(tk.LAUNCHES.values()) == 4
    for csr in (False, True):
        f = p["features"].clone().requires_grad_(True)
        w = p["weights"].clone().requires_grad_(True)
        y = pointwise_conv(p["points"], f, w, p["bias"], radius=0.2, csr=csr)
        (y * y).sum().backward()
        assert f.grad.abs().max() > 0 and w.grad.abs().max() > 0
    torch.cuda.synchronize()
    # each gradient: one walk of its mode and one product
    assert {k: v for k, v in tk.LAUNCHES.items() if k[:2] in ("dw", "dx")} \
        == {"dw_dense": 1, "dw_csr": 1, "dw_product": 2, "dx_dense": 1,
            "dx_csr": 1, "dx_product": 2}


@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_counts_kernel_matches_plain_and_forward(cuda, csr):
    # bit for bit: the plain version's counts and the forward kernel's own
    p = _scene_inputs(cuda, cin=124)
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=0.2, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], precision="bfloat16",
                        csr=csr)
    args = (kw["ctr"], kw["pts"], kw["radius"], kw["tile_ptr"],
            kw["tile_idx"])
    tk.reset_launches()
    cnt = tk.conv_counts(*args)
    cnt_p = tk.conv_counts_plain(*args)
    _, cnt_f = tk.conv_fwd(**kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["counts_csr" if csr else "counts_dense"] == 1
    assert cnt.sum() > 0
    assert torch.equal(cnt, cnt_p) and torch.equal(cnt, cnt_f)


def _ext_inputs(p, precision, csr, half):
    """Kernel inputs of the candidates in ``half`` (a slice) against all
    centers, and the counts over every candidate."""
    kw_all, _ = conv_layout(p["points"], p["features"], p["weights"], None,
                            radius=0.3, mask=p["mask"], centers=p["centers"],
                            center_mask=p["center_mask"],
                            precision=precision, csr=csr)
    cnt = tk.conv_counts(kw_all["ctr"], kw_all["pts"], 0.3,
                         kw_all["tile_ptr"], kw_all["tile_idx"])
    kw, _ = conv_layout(p["points"][:, half], p["features"][:, half],
                        p["weights"], None, radius=0.3,
                        mask=p["mask"][:, half], centers=p["centers"],
                        center_mask=p["center_mask"], precision=precision,
                        csr=csr)
    return kw_all, kw, cnt


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_ext_counts_forward_and_grads_match_plain(cuda, csr, precision):
    p = _scene_inputs(cuda, cin=124)
    _, kw, cnt = _ext_inputs(p, precision, csr, slice(0, 1536))
    y, own = tk.conv_fwd(**kw, cnt_in=cnt)
    y_p, own_p = tk.conv_fwd_plain(**kw, cnt_in=cnt)
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        tuple(y.shape)).astype(np.float32)).to(cuda)
    ptr_t = idx_t = None
    if csr:
        ptr_t, idx_t = tk.tile_adjacency(kw["pts"], kw["ctr"], 0.3)
    dw_args = (kw["ctr"], kw["pts"], kw["feats"], g, cnt, 0.3,
               kw["tile_ptr"], kw["tile_idx"])
    dx_args = (kw["ctr"], kw["pts"], g, cnt, kw["w"], 0.3, ptr_t, idx_t)
    dw, dx = tk.conv_dw(*dw_args), tk.conv_dx(*dx_args)
    again = tk.conv_dw(*dw_args), tk.conv_dx(*dx_args)
    dw_p, dx_p = tk.conv_dw_plain(*dw_args), tk.conv_dx_plain(*dx_args)
    torch.cuda.synchronize()
    assert torch.equal(own, own_p) and bool((own <= cnt).all())
    assert bool((own < cnt).any())       # the slab holds part of each ball
    _close(y, y_p, precision)
    _close(dw, dw_p, precision)
    _close(dx, dx_p, precision)
    assert torch.equal(dw, again[0]) and torch.equal(dx, again[1])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_ext_partials_sum_to_forward(cuda, precision):
    # the ring's identity: disjoint candidate slabs, divided by the counts
    # over all of them, sum to the forward over all of them
    p = _scene_inputs(cuda, cin=124)
    kw_all, _, cnt = _ext_inputs(p, precision, True, slice(0, 1))
    want, _ = tk.conv_fwd(**kw_all)
    for parts in (2, 4):
        edges = np.linspace(0, 3000, parts + 1).astype(int)
        total = None
        for a, b in zip(edges[:-1], edges[1:]):
            _, kw, _ = _ext_inputs(p, precision, True, slice(a, b))
            y, _ = tk.conv_fwd(**kw, cnt_in=cnt)
            total = y if total is None else total + y
        torch.cuda.synchronize()
        _close(total, want, precision)


def _all_cells_block(dev, cin, seed=0):
    """One 64 x 64 tile pair whose first 16 x 16 block of (center,
    candidate) pairs holds all 27 cells: 16 candidates on the 3 x 3 x 3
    offset grid (spacing 0.4, r = 0.75, one offset per cell) and 3 centers
    shifted by 0, 0.4 and 0.8 along x; the rest is sentinel padding (the
    CPU mirror's case, tests/test_torch_walk.py)."""
    offs = np.array([(x, y, z) for x in (-0.4, 0.0, 0.4)
                     for y in (-0.4, 0.0, 0.4) for z in (-0.4, 0.0, 0.4)],
                    np.float32)
    pts = np.full((1, tk.TILE, 3), tk.SENTINEL, np.float32)
    pts[0, :16] = offs[:16]
    ctr = np.full((1, tk.TILE, 3), -tk.SENTINEL, np.float32)
    ctr[0, :3] = [(0.0, 0.0, 0.0), (-0.4, 0.0, 0.0), (-0.8, 0.0, 0.0)]
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    return (t(ctr), t(pts), t(rng.standard_normal((1, tk.TILE, cin))),
            t(rng.standard_normal((27, cin, 16)) / np.sqrt(27 * cin)),
            t(rng.standard_normal(16) * 0.1))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_block_with_all_27_cells(cuda, precision):
    # the per-block cell skip must drop no cell of a block that holds all
    ctr, pts, feats, w, bias = _all_cells_block(cuda, 124)
    dt = getattr(torch, precision)
    kw = dict(ctr=ctr, pts=pts, feats=feats.to(dt), w=w.to(dt), bias=bias,
              radius=0.75)
    y, cnt = tk.conv_fwd(**kw)
    y_p, cnt_p = tk.conv_fwd_plain(**kw)
    g = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (1, tk.TILE, 16)).astype(np.float32)).to(cuda)
    dw_args = (ctr, pts, kw["feats"], g, cnt, 0.75)
    dw, dw_p = tk.conv_dw(*dw_args), tk.conv_dw_plain(*dw_args)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt_p)
    assert bool((cnt[0, :3].sum(0) > 0).all())       # all 27 cells
    _close(y, y_p, precision)
    _close(dw, dw_p, precision)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [3, 6, 124, tk.MAX_WIDTH])
def test_widths_walks_and_repeats(cuda, cin, precision):
    # forward and dW at each width: against the plain versions, the dense
    # and CSR walks identical bit for bit, two runs identical, counts equal
    # to the counts kernel's
    p = _scene_inputs(cuda, b=1, n=700, nc=600, cin=cin,
                      cout=tk.MAX_WIDTH if cin == tk.MAX_WIDTH else 124)
    outs = {}
    for csr in (False, True):
        kw, _ = conv_layout(p["points"], p["features"], p["weights"],
                            p["bias"], radius=0.3, mask=p["mask"],
                            centers=p["centers"],
                            center_mask=p["center_mask"],
                            precision=precision, csr=csr)
        y, cnt = tk.conv_fwd(**kw)
        y2, _ = tk.conv_fwd(**kw)
        y_p, cnt_p = tk.conv_fwd_plain(**kw)
        counts = tk.conv_counts(kw["ctr"], kw["pts"], 0.3, kw["tile_ptr"],
                                kw["tile_idx"])
        g = torch.from_numpy(np.random.RandomState(1).standard_normal(
            tuple(y.shape)).astype(np.float32)).to(cuda)
        dw_args = (kw["ctr"], kw["pts"], kw["feats"], g, cnt, 0.3,
                   kw["tile_ptr"], kw["tile_idx"])
        dw, dw2 = tk.conv_dw(*dw_args), tk.conv_dw(*dw_args)
        dw_p = tk.conv_dw_plain(*dw_args)
        torch.cuda.synchronize()
        assert torch.equal(cnt, cnt_p) and torch.equal(cnt, counts)
        assert cnt.sum() > 0
        assert torch.equal(y, y2) and torch.equal(dw, dw2)
        _close(y, y_p, precision)
        _close(dw, dw_p, precision)
        outs[csr] = (y, dw)
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)


def test_width_refused_above_the_limit(cuda):
    wide = tk.MAX_WIDTH + 1
    p = _scene_inputs(cuda, b=1, n=200, nc=150, cin=wide, cout=8)
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=0.3, precision="bfloat16")
    with pytest.raises(ValueError, match="wider than"):
        tk.conv_fwd(**kw)
    g = torch.zeros((1, kw["ctr"].shape[1], 8), device=cuda)
    cnt = torch.zeros((1, kw["ctr"].shape[1], 27), device=cuda)
    with pytest.raises(ValueError, match="wider than"):
        tk.conv_dw(kw["ctr"], kw["pts"], kw["feats"], g, cnt, 0.3)
    p = _scene_inputs(cuda, b=1, n=200, nc=150, cin=8, cout=wide)
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=0.3, precision="bfloat16")
    with pytest.raises(ValueError, match="Cout=1025 is wider"):
        tk.conv_fwd(**kw)
    g = torch.zeros((1, kw["ctr"].shape[1], wide), device=cuda)
    with pytest.raises(ValueError, match="Cout=1025 is wider"):
        tk.conv_dx(kw["ctr"], kw["pts"], g, cnt, kw["w"], 0.3)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_dx_sums_and_products_match_plain(cuda, csr, precision):
    # each backward kernel alone: dX's sums walk, dW's means walk, and the
    # two products on the same rounded operands as their plain versions
    p = _scene_inputs(cuda, cin=124)
    dw_args, dx_args = _grad_inputs(p, 0.2, precision, csr)
    ctr, pts, g, cnt, w, radius, ptr_t, idx_t = dx_args
    z = tk.conv_dx_sums(*dx_args[:4], radius, ptr_t, idx_t, w.dtype)
    z_p = tk.conv_dx_sums_plain(*dx_args[:4], radius, ptr_t, idx_t, w.dtype)
    xbar = tk.conv_dw_means(ctr, pts, dw_args[2], cnt, radius, *dw_args[6:])
    xbar_p = tk.conv_dw_means_plain(ctr, pts, dw_args[2], cnt, radius,
                                    *dw_args[6:])
    g2 = g.view(-1, g.shape[2])
    dw, dw_p = tk.conv_dw_product(xbar, g2), tk.conv_dw_product_plain(xbar, g2)
    dx, dx_p = tk.conv_dx_product(z, w), tk.conv_dx_product_plain(z, w)
    torch.cuda.synchronize()
    assert z.shape == z_p.shape and z.dtype == z_p.dtype == w.dtype
    assert z_p.abs().max() > 0 and dw_p.abs().max() > 0
    _close(z.float(), z_p.float(), precision)
    _close(xbar.float(), xbar_p.float(), precision)
    _close(dw, dw_p, "float32")
    _close(dx, dx_p, "float32")


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("cout", [3, 6, 124, tk.MAX_WIDTH])
def test_dx_widths_walks_and_repeats(cuda, cout, precision):
    # dX at each width: against the plain version, the dense and CSR walks
    # identical bit for bit, two runs identical
    p = _scene_inputs(cuda, b=1, n=700, nc=600, cin=124, cout=cout)
    outs = {}
    for csr in (False, True):
        _, dx_args = _grad_inputs(p, 0.3, precision, csr)
        dx, dx2 = tk.conv_dx(*dx_args), tk.conv_dx(*dx_args)
        dx_p = tk.conv_dx_plain(*dx_args)
        torch.cuda.synchronize()
        assert dx_p.abs().max() > 0
        assert torch.equal(dx, dx2)
        _close(dx, dx_p, precision)
        outs[csr] = dx
    assert torch.equal(outs[False], outs[True])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_dx_block_with_all_27_cells(cuda, precision):
    # the forward's all-cells block with the roles swapped (3 candidates as
    # rows, the 16 offsets negated as center columns): the per-block cell
    # skip of dX's walk must drop no cell
    ctr, pts, _, w, _ = _all_cells_block(cuda, 124)
    rows = torch.full_like(pts, tk.SENTINEL)
    rows[0, :3] = -ctr[0, :3]
    cols = torch.full_like(ctr, -tk.SENTINEL)
    cols[0, :16] = -pts[0, :16]
    cnt = tk.conv_counts(cols, rows, 0.75)
    g = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (1, tk.TILE, 16)).astype(np.float32)).to(cuda)
    args = (cols, rows, g, cnt, w.to(getattr(torch, precision)), 0.75)
    z = tk.conv_dx_sums(cols, rows, g, cnt, 0.75, dtype=args[4].dtype)
    z_p = tk.conv_dx_sums_plain(cols, rows, g, cnt, 0.75,
                                dtype=args[4].dtype)
    dx, dx_p = tk.conv_dx(*args), tk.conv_dx_plain(*args)
    torch.cuda.synchronize()
    cells = z_p.float().view(tk.TILE, 27, 16)[:3].abs().sum((0, 2))
    assert bool((cells > 0).all())                      # all 27 cells
    _close(z.float(), z_p.float(), precision)
    _close(dx, dx_p, precision)
