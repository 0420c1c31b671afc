"""Gradients of the port's pointwise conv held against ``jax.grad`` on the CPU.

The same numpy-seeded problem and the same upstream gradient go through
``jax.grad`` of the JAX package's Pallas op (interpret mode, as
tests/test_pointwise_conv.py runs it) and through ``torch.autograd`` of the
port's op, ``impl='auto'`` on CPU tensors: ``PointwiseConvFunction`` with
the plain versions ``conv_dw_plain`` / ``conv_dx_plain``.  The JAX side runs
its dense walk once per case and precision (its CSR walk computes the same
function, only slower in interpret mode); the port runs both of its walks
against it.

Tolerances: f32 rtol 1e-4 and atol 1e-4 * max|want| (the sums are taken in
another order than the TPU kernels' matmuls); bf16 max error <= 2e-2 *
max|want|, because both sides round g, the means, 1/count and the per-cell
sums Z to bf16 at the same points, but one bf16 ulp (2^-8 relative) of a
rounded intermediate flips wherever an f32 sum summed in another order
lands on a rounding boundary.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.ops import pointwise_conv as jax_conv
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.ops.pointwise_conv import conv_layout

CASES = {
    "masked": dict(masked=True),
    "centers": dict(nc=53, masked=True),
    "n777": dict(n=777, masked=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the CPU paths run many small ops; with the test workers sharing the
    # cores, more intra-op threads only add contention
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_problem(seed, b=2, n=96, cin=5, cout=7, spread=1.0, nc=None,
                 masked=False):
    rng = np.random.RandomState(seed)
    p = {
        "points": rng.uniform(-spread, spread, (b, n, 3)).astype(np.float32),
        "features": rng.standard_normal((b, n, cin)).astype(np.float32),
        "weights": (rng.standard_normal((27, cin, cout)) * 0.2).astype(
            np.float32),
        "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32),
    }
    if masked:
        p["mask"] = (rng.rand(b, n) > 0.25).astype(np.float32)
    if nc is not None:
        p["centers"] = rng.uniform(-spread, spread, (b, nc, 3)).astype(
            np.float32)
        p["center_mask"] = (rng.rand(b, nc) > 0.3).astype(np.float32)
    n_out = n if nc is None else nc
    gdir = rng.standard_normal((b, n_out, cout)).astype(np.float32)
    return p, gdir


def jax_grads(p, gdir, **kw):
    rest = {k: jnp.asarray(v) for k, v in p.items()
            if k not in ("points", "features", "weights", "bias")}
    pts = jnp.asarray(p["points"])

    def loss(f, w, b):
        y = jax_conv(pts, f, w, b, impl="pallas", **rest, **kw)
        return jnp.sum(y * jnp.asarray(gdir))

    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(p["features"]), jnp.asarray(p["weights"]),
        jnp.asarray(p["bias"]))
    return [np.asarray(x) for x in g]


def torch_grads(p, gdir, **kw):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    leaves = [t.pop(k).requires_grad_(True)
              for k in ("features", "weights", "bias")]
    y = pointwise_conv(t.pop("points"), *leaves, impl="auto", **t, **kw)
    (y * torch.from_numpy(gdir)).sum().backward()
    return [x.grad.numpy() for x in leaves]


def assert_grad_close(got, want, precision):
    scale = max(float(np.abs(want).max()), 1e-6)
    if precision == "bfloat16":
        err = float(np.abs(got - want).max())
        assert err <= 2e-2 * scale, (err, scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@functools.lru_cache(maxsize=None)
def jax_case(case, precision):
    p, gdir = make_problem(11, **CASES[case])
    return p, gdir, jax_grads(p, gdir, radius=0.3, precision=precision,
                              csr=False)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax(case, csr, precision):
    p, gdir, want = jax_case(case, precision)
    got = torch_grads(p, gdir, radius=0.3, precision=precision, csr=csr)
    for name, gw, gt in zip(("features", "weights", "bias"), want, got):
        assert gt.shape == gw.shape, name
        assert_grad_close(gt, gw, precision)
    assert np.abs(got[1]).max() > 0 and np.abs(got[0]).max() > 0


@pytest.mark.parametrize("radius", [1.0, 2.0 ** 0.5, 2.0])
def test_plus_r_grads_match_jax(radius):
    # points on an exact grid: many pairs at exactly the radius and on cell
    # faces; dX must route gradient through the cells the forward used
    g = np.stack(np.meshgrid(*([np.arange(3.0)] * 3)), -1).reshape(1, 27, 3)
    rng = np.random.RandomState(3)
    p = {"points": g.astype(np.float32),
         "features": rng.standard_normal((1, 27, 4)).astype(np.float32),
         "weights": (rng.standard_normal((27, 4, 4)) * 0.2).astype(np.float32),
         "bias": np.zeros(4, np.float32)}
    gdir = rng.standard_normal((1, 27, 4)).astype(np.float32)
    want = jax_grads(p, gdir, radius=radius)
    for csr in (False, True):
        got = torch_grads(p, gdir, radius=radius, csr=csr)
        for gw, gt in zip(want, got):
            assert_grad_close(gt, gw, "float32")


def test_zero_grad_at_masked_candidates_and_padding():
    p, gdir = make_problem(12, n=150, masked=True)
    got = torch_grads(p, gdir, radius=0.4)
    assert np.all(got[0][p["mask"] == 0] == 0)
    assert np.abs(got[0][p["mask"] > 0]).max() > 0
    # the kernel-level dX is zero on the sentinel padding rows too
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    kw, _ = conv_layout(t["points"], t["features"], t["weights"], t["bias"],
                        radius=0.4, mask=t["mask"])
    _, cnt = tk.conv_fwd(**kw)
    g = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, kw["ctr"].shape[1], 7)).astype(np.float32))
    dx = tk.conv_dx(kw["ctr"], kw["pts"], g, cnt, kw["w"], 0.4)
    assert dx.shape == (2, kw["pts"].shape[1], 5)
    assert torch.all(dx[:, 150:] == 0)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_walks_give_identical_grads(precision):
    p, gdir = make_problem(13, n=700, masked=True)
    dense = torch_grads(p, gdir, radius=0.25, csr=False, precision=precision)
    csr = torch_grads(p, gdir, radius=0.25, csr=True, precision=precision)
    for a, b in zip(dense, csr):
        np.testing.assert_array_equal(a, b)


def test_feature_grad_skipped_when_not_needed(monkeypatch):
    # layer 0 reads the input features: no dX call, dW and dbias still run
    p, gdir = make_problem(14)
    calls = []
    op = importlib.import_module("pointwise_torch.ops.pointwise_conv")
    monkeypatch.setattr(op, "conv_dx", lambda *a, **k: calls.append(1))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    w = t["weights"].requires_grad_(True)
    y = pointwise_conv(t["points"], t["features"], w, t["bias"], radius=0.3)
    (y * torch.from_numpy(gdir)).sum().backward()
    assert not calls and w.grad is not None and w.grad.abs().max() > 0
    assert w.grad.dtype == torch.float32


def test_grad_wrappers_check_inputs():
    p, _ = make_problem(15)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    kw, _ = conv_layout(t["points"], t["features"], t["weights"], t["bias"],
                        radius=0.5)
    _, cnt = tk.conv_fwd(**kw)
    g = torch.zeros(2, kw["ctr"].shape[1], 7)
    with pytest.raises(ValueError, match="g must be"):
        tk.conv_dw(kw["ctr"], kw["pts"], kw["feats"], g[:, :5], cnt, 0.5)
    with pytest.raises(ValueError, match="cnt must be"):
        tk.conv_dx(kw["ctr"], kw["pts"], g, cnt[..., :5], kw["w"], 0.5)
    with pytest.raises(ValueError, match="tile_ptr must be"):
        ptr, idx = tk.tile_adjacency(kw["ctr"], kw["pts"], 0.5)
        tk.conv_dx(kw["ctr"], kw["pts"], g, cnt, kw["w"], 0.5,
                   torch.cat([ptr, ptr]), idx)
