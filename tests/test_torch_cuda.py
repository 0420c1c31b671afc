"""The CUDA kernels (forward, dW, dX) against their plain PyTorch versions,
on the card.

Marked ``cuda``: the ``cuda`` fixture skips each test when no card is
present (decided inside the fixture, never at import).  On a host with an
NVIDIA Hopper GPU run
``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py`` (the
repository conftest sets JAX up for the CPU tests; these need none of it).
Tolerances: f32 1e-4, relative to max |want| for the gradients (the plain
version sums with atomics in another order); bf16 2e-2 relative to
max |want| (one bf16 ulp of a rounded mean or per-cell sum can flip).
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
    assert tk.LAUNCHES == dict(tk.LAUNCHES, fwd_dense=1, fwd_csr=1)
    assert sum(tk.LAUNCHES.values()) == 2
    for csr in (False, True):
        f = p["features"].clone().requires_grad_(True)
        w = p["weights"].clone().requires_grad_(True)
        y = pointwise_conv(p["points"], f, w, p["bias"], radius=0.2, csr=csr)
        (y * y).sum().backward()
        assert f.grad.abs().max() > 0 and w.grad.abs().max() > 0
    torch.cuda.synchronize()
    assert {k: v for k, v in tk.LAUNCHES.items() if k[:2] in ("dw", "dx")} \
        == {"dw_dense": 1, "dw_csr": 1, "dx_dense": 1, "dx_csr": 1}
