"""Counts and external counts of the port held against the JAX package.

``pointwise_conv_counts`` and ``pointwise_conv(ext_counts=)`` get the same
numpy-seeded inputs on both sides.  JAX runs its Pallas op in interpret mode
(``impl='pallas'``); the port runs ``impl='auto'`` on CPU tensors, the plain
versions of its counts and forward kernels, in both walks.

Tolerances: counts are integers and must be equal.  The ext-counts forward
and its sums over disjoint candidate subsets: f32 2e-5 (the tolerance of the
JAX package's own spatial tests; the sums are taken in another order);
bf16 2e-2 relative to max |y| (one bf16 ulp of a rounded mean).
Gradients: f32 3e-5 relative to max |grad|, bf16 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.ops import pointwise_conv as jax_conv
from pointwise_tpu.ops import pointwise_conv_counts as jax_counts
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops import pointwise_conv, pointwise_conv_counts
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


def make_problem(seed, b=2, n=96, cin=5, cout=7, nc=None, masked=False):
    rng = np.random.RandomState(seed)
    p = {
        "points": rng.uniform(-1, 1, (b, n, 3)).astype(np.float32),
        "features": rng.standard_normal((b, n, cin)).astype(np.float32),
        "weights": (rng.standard_normal((27, cin, cout)) * 0.2).astype(
            np.float32),
    }
    if masked:
        p["mask"] = (rng.rand(b, n) > 0.25).astype(np.float32)
    if nc is not None:
        p["centers"] = rng.uniform(-1, 1, (b, nc, 3)).astype(np.float32)
        p["center_mask"] = (rng.rand(b, nc) > 0.3).astype(np.float32)
    return p


def crafted_grid(radius):
    """A grid of spacing r/3 (dyadic r): pairs at exactly r and on cell
    faces."""
    g = np.stack(np.meshgrid(*([np.arange(5.0)] * 3)), -1).reshape(1, -1, 3)
    return (g * (radius / 3.0)).astype(np.float32)


def geometry(p):
    return {k: p[k] for k in ("mask", "centers", "center_mask") if k in p}


def t(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def j(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_match_jax(case, csr):
    p = make_problem(20, **CASES[case])
    want = np.asarray(jax_counts(jnp.asarray(p["points"]), radius=0.4,
                                 **j(geometry(p))))
    got = pointwise_conv_counts(torch.from_numpy(p["points"]), radius=0.4,
                                csr=csr, **t(geometry(p)))
    assert got.dtype == torch.float32 and not got.requires_grad
    assert got.shape == want.shape and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [0.375, 0.75])
def test_counts_crafted_grid_at_exactly_r(radius):
    pts = crafted_grid(radius)
    want = np.asarray(jax_counts(jnp.asarray(pts), radius=radius))
    for csr in (False, True):
        got = pointwise_conv_counts(torch.from_numpy(pts), radius=radius,
                                    csr=csr)
        np.testing.assert_array_equal(got.numpy(), want)
    # unbatched input keeps its rank, as the JAX op does
    got = pointwise_conv_counts(torch.from_numpy(pts[0]), radius=radius)
    np.testing.assert_array_equal(got.numpy(), want[0])


@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_counts_equal_forward_counts(csr):
    p = t(make_problem(21, n=300, nc=200, masked=True))
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], None,
                        radius=0.3, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], csr=csr)
    _, cnt = tk.conv_fwd(**kw)
    counts = tk.conv_counts(kw["ctr"], kw["pts"], 0.3, kw["tile_ptr"],
                            kw["tile_idx"])
    assert torch.equal(counts, cnt) and cnt.sum() > 0
    op = pointwise_conv_counts(p["points"], radius=0.3, mask=p["mask"],
                               centers=p["centers"],
                               center_mask=p["center_mask"], csr=csr)
    assert torch.equal(op, cnt[:, :200])


def _subsets(n, parts):
    edges = np.linspace(0, n, parts + 1).astype(int)
    return [slice(a, b) for a, b in zip(edges[:-1], edges[1:])]


def _sub(p, sl):
    return {k: (v[:, sl] if k in ("points", "features", "mask") else v)
            for k, v in p.items()}


def _close(got, want, precision, tol=2e-5):
    scale = max(float(np.abs(want).max()), 1e-6)
    if precision == "bfloat16":
        assert float(np.abs(got - want).max()) <= 2e-2 * scale
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@functools.lru_cache(maxsize=None)
def ext_case(precision):
    """Counts over every candidate, and the JAX ext conv over the first of
    two candidate subsets."""
    p = make_problem(22, n=160, nc=70, masked=True)
    counts = np.array(jax_counts(jnp.asarray(p["points"]), radius=0.5,
                                 **j(geometry(p))))
    q = _sub(p, slice(0, 90))
    args = j(q)
    want = np.asarray(jax_conv(
        args.pop("points"), args.pop("features"), args.pop("weights"), None,
        radius=0.5, impl="pallas", precision=precision, csr=False,
        ext_counts=jnp.asarray(counts), **args))
    return p, counts, want


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_ext_counts_conv_matches_jax(csr, precision):
    p, counts, want = ext_case(precision)
    args = t(_sub(p, slice(0, 90)))
    got = pointwise_conv(args.pop("points"), args.pop("features"),
                         args.pop("weights"), radius=0.5, precision=precision,
                         csr=csr, ext_counts=torch.from_numpy(counts),
                         **args).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    _close(got, want, precision)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_partial_sums_equal_full_conv(precision):
    # the ring's identity: partials over disjoint candidate subsets, divided
    # by the counts over all of them, sum to the conv over all of them
    p = make_problem(23, n=200, nc=80, masked=True)
    tp = t(p)
    counts = pointwise_conv_counts(tp["points"], radius=0.5,
                                   **t(geometry(p)))
    full = pointwise_conv(tp["points"], tp["features"], tp["weights"],
                          radius=0.5, precision=precision,
                          **t(geometry(p))).numpy()
    want = np.asarray(jax_conv(
        jnp.asarray(p["points"]), jnp.asarray(p["features"]),
        jnp.asarray(p["weights"]), None, radius=0.5, impl="pallas",
        precision=precision, **j(geometry(p))))
    _close(full, want, precision)
    for parts in (2, 3):
        total = 0.0
        for sl in _subsets(200, parts):
            q = t(_sub(p, sl))
            total = total + pointwise_conv(
                q.pop("points"), q.pop("features"), q.pop("weights"),
                radius=0.5, precision=precision, ext_counts=counts,
                **q).float().numpy()
        _close(total, full, precision)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_ext_counts_grads_match_jax(csr, precision):
    p, counts, _ = ext_case(precision)
    q = _sub(p, slice(0, 90))
    gdir = np.random.RandomState(24).standard_normal(
        (2, 70, 7)).astype(np.float32)
    rest = {k: v for k, v in q.items()
            if k not in ("points", "features", "weights")}

    def jloss(f, w):
        y = jax_conv(jnp.asarray(q["points"]), f, w, None, radius=0.5,
                     impl="pallas", precision=precision, csr=False,
                     ext_counts=jnp.asarray(counts), **j(rest))
        return jnp.sum(y * jnp.asarray(gdir))

    want = [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(q["features"]), jnp.asarray(q["weights"]))]
    f = torch.from_numpy(q["features"]).requires_grad_(True)
    w = torch.from_numpy(q["weights"]).requires_grad_(True)
    y = pointwise_conv(torch.from_numpy(q["points"]), f, w, radius=0.5,
                       precision=precision, csr=csr,
                       ext_counts=torch.from_numpy(counts), **t(rest))
    (y * torch.from_numpy(gdir)).sum().backward()
    for got, w_ in zip((f.grad.numpy(), w.grad.numpy()), want):
        assert np.abs(w_).max() > 0
        _close(got, w_, precision, tol=3e-5)


def test_bias_with_ext_counts_raises():
    p = make_problem(25)
    counts = np.ones((2, 96, 27), np.float32)
    bias = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="partial convolution"):
        jax_conv(jnp.asarray(p["points"]), jnp.asarray(p["features"]),
                 jnp.asarray(p["weights"]), jnp.asarray(bias), radius=0.5,
                 ext_counts=jnp.asarray(counts))
    with pytest.raises(ValueError, match="partial convolution"):
        pointwise_conv(torch.from_numpy(p["points"]),
                       torch.from_numpy(p["features"]),
                       torch.from_numpy(p["weights"]), torch.from_numpy(bias),
                       radius=0.5, ext_counts=torch.from_numpy(counts))


def test_counts_wrapper_checks_inputs():
    p = t(make_problem(26))
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], None,
                        radius=0.5)
    with pytest.raises(ValueError, match="multiples of 64"):
        tk.conv_counts(kw["ctr"][:, :50], kw["pts"], 0.5)
    with pytest.raises(ValueError, match="cnt_in must be"):
        tk.conv_fwd(**kw, cnt_in=torch.ones(2, 64, 5))
