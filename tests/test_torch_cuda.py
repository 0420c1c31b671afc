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

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointwise_torch.data import shapenetpart, synthetic
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.ops.pointwise_conv import conv_layout
from pointwise_torch.tools import walk_split
from pointwise_torch.utils.spatial import morton_sort

pytestmark = pytest.mark.cuda
# the op layer's module (the package's ``pointwise_conv`` is the function)
op_module = importlib.import_module("pointwise_torch.ops.pointwise_conv")


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
    # dX: one walk of its mode and one product; dW: the product alone, over
    # the forward's kept means
    assert {k: v for k, v in tk.LAUNCHES.items() if k[:2] in ("dw", "dx")} \
        == {"dw_dense": 0, "dw_csr": 0, "dw_product": 2, "dx_dense": 1,
            "dx_csr": 1, "dx_product": 2}
    assert op_module.DW_XBAR == {"kept": 2, "walked": 0}


def test_function_dw_reads_the_forwards_means(cuda):
    # the shapes' width (Cin 124, bf16, 4 x 2048): the Function's dW, the
    # product over the forward's kept means, equals dW's own walk and
    # product bit for bit, and its backward launches no dW walk
    p = _scene_inputs(cuda, b=4, n=2048, nc=2048, cin=124)
    rng = np.random.RandomState(5)
    runs = {}
    tk.reset_launches()
    for csr in (False, True):
        kw, _ = conv_layout(p["points"], p["features"], p["weights"],
                            p["bias"], radius=0.2, mask=p["mask"],
                            precision="bfloat16", csr=csr)
        w = p["weights"].clone().requires_grad_(True)
        y, cnt = op_module.PointwiseConvFunction.apply(
            kw["feats"], w, kw["bias"], kw["ctr"], kw["pts"], kw["radius"],
            kw["tile_ptr"], kw["tile_idx"])
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
            np.float32)).to(cuda)
        y.backward(g)
        runs[csr] = (kw, w.grad, g, cnt)
    torch.cuda.synchronize()
    assert (tk.LAUNCHES["dw_dense"], tk.LAUNCHES["dw_csr"],
            tk.LAUNCHES["dw_product"]) == (0, 0, 2)
    assert op_module.DW_XBAR == {"kept": 2, "walked": 0}
    for csr, (kw, dw, g, cnt) in runs.items():
        want = tk.conv_dw(kw["ctr"], kw["pts"], kw["feats"], g, cnt,
                          kw["radius"], kw["tile_ptr"], kw["tile_idx"])
        assert dw.abs().max() > 0
        assert torch.equal(dw, want), csr
    assert (tk.LAUNCHES["dw_dense"], tk.LAUNCHES["dw_csr"]) == (1, 1)


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


def _padded(a, rows, fill):
    """(B, n, 3) numpy coordinates padded to ``rows`` with ``fill``."""
    out = np.full((a.shape[0], rows, 3), fill, np.float32)
    out[:, :a.shape[1]] = a
    return out


def _counts_case(case, dev):
    """Kernel-level (ctr, pts, radius) of one counts case."""
    rng = np.random.RandomState(7)
    s = tk.SENTINEL
    if case == "empty_row":
        # center row 1 lies far from every candidate: its CSR list is empty
        pts = rng.uniform(0, 1, (2, 256, 3)).astype(np.float32)
        ctr = np.concatenate([pts[:, :64], pts[:, 64:128] + 10.0], 1)
        r = 0.3
    elif case == "masked_padded":
        # 2,500 centers, a tenth masked, padded to 2,560; masked candidates
        p = _scene_inputs(dev, cin=3)
        kw, _ = conv_layout(p["points"], p["features"], p["weights"],
                            p["bias"], radius=0.2, mask=p["mask"],
                            centers=p["centers"],
                            center_mask=p["center_mask"])
        return kw["ctr"], kw["pts"], 0.2
    elif case == "many_rows":
        # 5 x 64 rows of 4,096 candidates each
        pts = rng.uniform(-1, 1, (5, 4096, 3)).astype(np.float32)
        ctr, r = pts, 0.2
    elif case == "wide":
        # Mp = 256 x Ncp
        pts = rng.uniform(-1, 1, (1, 16384, 3)).astype(np.float32)
        ctr, r = pts[:, :64], 0.4
    elif case.startswith("exactly_r"):
        # tests/test_torch_counts.py's grid of spacing r/3: pairs at exactly
        # r and on cell faces
        r = float(case.split("_")[-1])
        g = np.stack(np.meshgrid(*([np.arange(5.0)] * 3)), -1).reshape(1, -1, 3)
        pts = (g * (r / 3.0)).astype(np.float32)
        ctr = _padded(pts, 128, -s)
        pts = _padded(pts, 128, s)
    else:   # over_65535: 70,016 candidates in cell 13 of every center
        ctr = np.zeros((1, 64, 3), np.float32)
        pts = np.full((1, 70016, 3), 0.05, np.float32)
        r = 0.3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return t(ctr), t(pts), r


COUNTS_CASES = [("empty_row", True), ("many_rows", False),
                ("many_rows", True), ("masked_padded", False),
                ("masked_padded", True), ("wide", False),
                ("exactly_r_0.375", False), ("exactly_r_0.375", True),
                ("exactly_r_0.75", False), ("exactly_r_0.75", True),
                ("over_65535", False), ("over_65535", True)]


@pytest.mark.parametrize("case,csr", COUNTS_CASES,
                         ids=[f"{c}-{'csr' if x else 'dense'}"
                              for c, x in COUNTS_CASES])
def test_counts_kernel_edge_cases(cuda, case, csr):
    # bit for bit against the plain version and the forward's own counts,
    # and from one launch to the next
    ctr, pts, r = _counts_case(case, cuda)
    ptr = idx = None
    if csr:
        ptr, idx = tk.tile_adjacency(ctr, pts, r)
    args = (ctr, pts, r, ptr, idx)
    feats = torch.ones(pts.shape[:2] + (3,), device=cuda)
    w, bias = (torch.zeros(27, 3, 4, device=cuda),
               torch.zeros(4, device=cuda))
    tk.reset_launches()
    cnt, again = tk.conv_counts(*args), tk.conv_counts(*args)
    _, own = tk.conv_fwd(ctr, pts, feats, w, bias, r, ptr, idx)
    plain = tk.conv_counts_plain(*args)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["counts_csr" if csr else "counts_dense"] == 2
    assert cnt.sum() > 0
    assert torch.equal(cnt, again)
    assert torch.equal(cnt, plain) and torch.equal(cnt, own)
    real = ctr[..., 0] > -tk.SENTINEL / 2
    assert float(cnt[~real].abs().sum()) == 0.0
    if case == "empty_row":
        n = (ptr[1:] - ptr[:-1]).view(2, 2)
        assert bool((n[:, 1] == 0).all()) and bool((n[:, 0] > 0).all())
        assert float(cnt[:, 64:].sum()) == 0.0
    if case == "masked_padded":
        assert bool((~real).any())
    if case == "over_65535":
        assert bool((cnt[..., 13] == 70016).all())
        assert float(cnt.sum()) == 64 * 70016


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


@pytest.mark.parametrize("cin", [57, 64, 124, 127, 128, 254, tk.MAX_WIDTH])
def test_tma_walk_widths_edges_and_repeats(cuda, cin):
    # the forward's bf16 walk at NT = 16 (Cin > 56) stages its features by
    # TMA into swizzled boxes: one to eight channel groups, a row tile with
    # an empty CSR list (its centers masked), rows of 9 and 11 listed tiles
    # (a last iteration of one tile); against the plain means, the dense
    # and CSR walks identical bit for bit, two runs identical, counts equal
    # to the counts kernel's, the same bits as dW's walk (the same means
    # staged by cp.async), and the external-counts forward (cnt_in)
    p = _scene_inputs(cuda, b=2, n=700, nc=600, cin=cin, seed=cin)
    p["center_mask"][0, 64:128] = False
    outs = {}
    for csr in (False, True):
        kw, _ = conv_layout(p["points"], p["features"], p["weights"],
                            p["bias"], radius=0.3, mask=p["mask"],
                            centers=p["centers"],
                            center_mask=p["center_mask"],
                            precision="bfloat16", csr=csr)
        walk = (kw["ctr"], kw["pts"], kw["feats"], 0.3, kw["tile_ptr"],
                kw["tile_idx"])
        tk.reset_launches()
        xbar, cnt = tk.conv_fwd_means(*walk)
        again, _ = tk.conv_fwd_means(*walk)
        ext = 2.0 * cnt + 1.0
        xbar_e, _ = tk.conv_fwd_means(*walk, cnt_in=ext)
        xbar_dw = tk.conv_dw_means(*walk[:3], cnt, 0.3, *walk[4:])
        counts = tk.conv_counts(kw["ctr"], kw["pts"], 0.3, kw["tile_ptr"],
                                kw["tile_idx"])
        torch.cuda.synchronize()
        assert tk.LAUNCHES["fwd_csr" if csr else "fwd_dense"] == 2
        xbar_p, cnt_p = tk.conv_fwd_means_plain(*walk)
        xbar_ep, _ = tk.conv_fwd_means_plain(*walk, cnt_in=ext)
        if csr:
            assert int(kw["tile_ptr"][2] - kw["tile_ptr"][1]) == 0
        assert torch.equal(cnt, cnt_p) and torch.equal(cnt, counts)
        assert cnt.sum() > 0 and cnt[0, 64:128].sum() == 0
        assert torch.equal(xbar, again) and torch.equal(xbar, xbar_dw)
        _close(xbar.float(), xbar_p.float(), "bfloat16")
        _close(xbar_e.float(), xbar_ep.float(), "bfloat16")
        outs[csr] = xbar
    assert torch.equal(outs[False], outs[True])


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


@pytest.mark.parametrize("rows", [64, 64 * 37])
@pytest.mark.parametrize("k_width,n", [(3, 124), (6, 3), (124, 124),
                                       (64, 64), (124, 128),
                                       (tk.MAX_WIDTH, tk.MAX_WIDTH),
                                       (tk.MAX_WIDTH, 3),
                                       (3, tk.MAX_WIDTH)])
@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_product_kernel(cuda, kind, k_width, n, rows):
    # the TMA / wgmma product alone, the forward's with a bias and dX's
    # without: K = 27 x width past a multiple of 64 and up to MAX_WIDTH, N
    # tiles from 8 to 4 x 256, less than one row tile and a partial last
    # one, a row stride past K with NaN in the columns the kernel must not
    # read; two runs and the product of rows 64.. (a row shard) identical
    # bit for bit
    rng = np.random.RandomState(7 * k_width + n + rows)
    k = 27 * k_width
    a = np.full((rows, tk.round_up(k, 8) + 8), np.nan, np.float32)
    a[:, :k] = rng.standard_normal((rows, k))
    a = torch.from_numpy(a).to(cuda).bfloat16()[:, :k]
    cin, cout = (k_width, n) if kind == "fwd" else (n, k_width)
    w = torch.from_numpy((rng.standard_normal((27, cin, cout))
                          / np.sqrt(k)).astype(np.float32)).to(cuda).bfloat16()
    if kind == "fwd":
        bias = torch.from_numpy(
            0.1 * rng.standard_normal(n).astype(np.float32)).to(cuda)
        run = lambda x: tk.conv_fwd_product(x, w, bias)          # noqa
        want = tk.conv_fwd_product_plain(a, w, bias)
    else:
        run = lambda x: tk.conv_dx_product(x, w)                 # noqa
        want = tk.conv_dx_product_plain(a, w)
    tk.reset_launches()
    y, again, shard = run(a), run(a), run(a[64:])
    torch.cuda.synchronize()
    assert tk.LAUNCHES[f"{kind}_product"] == (3 if rows > 64 else 2)
    assert y.shape == (rows, n) and bool(torch.isfinite(y).all())
    assert torch.equal(y, again)
    assert torch.equal(shard, y[64:])
    _close(y, want, "float32")


@pytest.mark.parametrize("rows", [64, 64 * 37, 64 * 133])
@pytest.mark.parametrize("cin,cout", [(3, 124), (6, 3), (64, 64),
                                      (124, 124), (124, 128),
                                      (tk.MAX_WIDTH, tk.MAX_WIDTH),
                                      (tk.MAX_WIDTH, 3), (3, tk.MAX_WIDTH)])
def test_dw_product_kernel(cuda, cin, cout, rows):
    # dW's TMA / wgmma product alone (xbar^T read M-major, g rounded and
    # laid out K-major): K = 27 x Cin past a multiple of 64 and up to
    # MAX_WIDTH, Cout tiles from 8 to 4 x 256, one 64-center k-step, 37
    # or 133 k-steps in slices (a short last one at 133 and at 37 x 124
    # wide; one slice where 108 or 864 tiles fill the card);
    # NaN in xbar's row stride past K, which the kernel must not read; two
    # runs identical bit for bit; f32 mode on the same slices
    rng = np.random.RandomState(11 * cin + cout + rows)
    k = 27 * cin
    x = np.full((rows, tk.round_up(k, 8) + 8), np.nan, np.float32)
    x[:, :k] = rng.standard_normal((rows, k))
    x = torch.from_numpy(x).to(cuda)
    xbar = x.bfloat16()[:, :k]
    g = torch.from_numpy(rng.standard_normal((rows, cout)).astype(
        np.float32)).to(cuda)
    plan = tk.dw_product_plan(rows, k, cout, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    if rows > 64 and 2 * plan["tiles"] <= tk.DW_UNITS:
        assert plan["slices"] > 1
    if rows == 64 * 133 and plan["slices"] > 1:     # a short last slice
        assert plan["slices"] * plan["chunk"] > rows
    tk.reset_launches()
    dw, again = tk.conv_dw_product(xbar, g), tk.conv_dw_product(xbar, g)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["dw_product"] == 2
    assert dw.shape == (27, cin, cout) and bool(torch.isfinite(dw).all())
    assert torch.equal(dw, again)
    _close(dw, tk.conv_dw_product_plain(xbar, g), "float32")
    if cin <= 124:
        xf = x[:, :k]
        _close(tk.conv_dw_product(xf, g), tk.conv_dw_product_plain(xf, g),
               "float32")


def _cull_scene(case, dev):
    """(points (B, N, 3), radius) of one cull case: 32 synthetic 2,048-point
    shapes at the smallest and the largest radius of the part segmenter,
    32 x 1,024 clouds at the classifier's largest (scaled by 1.25, its
    augmentation's top: all but a few outliers' k-steps kept), and two
    clusters 4 apart at r = 0.5 (each CTA drops the other cluster)."""
    if case.startswith("shapes"):
        pts = shapenetpart.load_shapenetpart(None, n_points=2048,
                                             synthetic_size=32).points
        r = float(case.split("_")[1])
    elif case == "clouds":
        pts = shapenetpart.load_shapenetpart(
            None, n_points=1024, synthetic_size=32).points * np.float32(1.25)
        r = 2.0
    else:
        a = shapenetpart.load_shapenetpart(None, n_points=1024,
                                           synthetic_size=4).points * 0.5
        pts = np.concatenate([a, a + np.float32([4.0, 0.0, 0.0])], 1)
        r = 0.5
    return torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev), r


@pytest.mark.parametrize("case", ["shapes_0.1", "shapes_0.6", "clouds",
                                  "clusters"])
def test_cull_keeps_the_walks_equalities(cuda, case):
    # the forward's TMA walk, dW's and dX's cp.async walks with the cull,
    # 124 wide in bf16: dense == CSR, two runs, the counts the counts
    # kernel's and the plain version's, dW's means the forward's
    pts, r = _cull_scene(case, cuda)
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.standard_normal(
        pts.shape[:2] + (124,)).astype(np.float32)).to(cuda)
    w = torch.zeros((27, 124, 124), device=cuda)
    g = torch.from_numpy(rng.standard_normal(
        (pts.shape[0], tk.round_up(pts.shape[1], tk.TILE), 124)).astype(
        np.float32)).to(cuda)
    outs = {}
    for csr in (False, True):
        kw, _ = conv_layout(pts, feats, w, None, radius=r,
                            precision="bfloat16", csr=csr)
        walk = (kw["ctr"], kw["pts"], kw["feats"], r, kw["tile_ptr"],
                kw["tile_idx"])
        xbar, cnt = tk.conv_fwd_means(*walk)
        again, _ = tk.conv_fwd_means(*walk)
        xbar_dw = tk.conv_dw_means(*walk[:3], cnt, r, *walk[4:])
        ptr_t = idx_t = None
        if csr:
            ptr_t, idx_t = tk.tile_adjacency(kw["pts"], kw["ctr"], r)
        dx_args = (kw["ctr"], kw["pts"], g, cnt, r, ptr_t, idx_t,
                   torch.bfloat16)
        z, z2 = tk.conv_dx_sums(*dx_args), tk.conv_dx_sums(*dx_args)
        counts = tk.conv_counts(kw["ctr"], kw["pts"], r, kw["tile_ptr"],
                                kw["tile_idx"])
        share = tk.walk_cull_share(*walk[:2], r, *walk[4:])
        torch.cuda.synchronize()
        assert cnt.sum() > 0
        assert torch.equal(cnt, counts)
        assert torch.equal(xbar, again) and torch.equal(xbar, xbar_dw)
        assert torch.equal(z, z2)
        if case == "clouds":              # a few outliers beyond 2.0
            assert share > 0.99
        else:       # the CSR lists hold a part of the dense walk's k-steps
            assert share < (1.0 if csr else 0.25 if case == "shapes_0.1"
                            else 0.6)
        outs[csr] = (xbar, cnt, z)
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    if case != "shapes_0.6":           # the plain counts: a few seconds
        assert torch.equal(outs[False][1], tk.conv_counts_plain(
            kw["ctr"], kw["pts"], r, kw["tile_ptr"], kw["tile_idx"]))


@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_instrumented_walk_counts_the_kept_ksteps(cuda, csr, monkeypatch):
    # the instrumented walk (pointwise_torch/tools/walk_split.py) counts the
    # k-steps its CTAs keep: their share is walk_cull_share's (the tool
    # raises otherwise), and every CTA of a row block lists the same k-steps
    pts, r = _cull_scene("shapes_0.1", cuda)
    pts = pts[:8]
    feats = torch.from_numpy(np.random.RandomState(4).standard_normal(
        pts.shape[:2] + (124,)).astype(np.float32)).to(cuda)
    w = torch.zeros((27, 124, 8), device=cuda)
    if csr:     # the op takes the CSR walk from 3,585 candidates: force it
        monkeypatch.setattr(op_module, "_CSR_MIN_TILES", 1)
    mod = SimpleNamespace(kernel=w, bias=None, radius=r,
                          precision="bfloat16")
    rec = walk_split.split_layer(walk_split.build(), mod,
                                 (pts, feats, None, None, None), cuda)
    kw, _ = conv_layout(pts, feats, w, radius=r, precision="bfloat16")
    kept, listed = tk.walk_cull_counts(kw["ctr"], kw["pts"], r,
                                       kw["tile_ptr"], kw["tile_idx"])
    ks = rec["ksteps"]
    assert rec["walk"] == ("csr" if csr else "dense")
    assert ks["listed"] % listed == 0
    assert ks["kept"] == kept * (ks["listed"] // listed)
    assert 0 < kept < listed and rec["cull_share"] == kept / listed
