"""The op's exact sub-block mode (``pointwise_conv(..., subblock=S)``) on
the CPU, against the JAX op.

Mirrors tests/test_pointwise_conv.py's subblock tests: the same inputs go
through the JAX op (``impl="reference"``, the dense executable spec, with
and without ``subblock``) and the port (its plain kernel path, and its
``impl="reference"``).  Tolerances are the JAX tests' own: forward 1e-6
where the same conv runs underneath (sub-block against dense), grads 1e-5
(per-sub-block accumulation reorders the f32 sums); the port against JAX
1e-5 forward and 1e-4 grads, the cross-framework tolerance of
tests/test_torch_grad.py's f32 gradients.  Each case also checks which
branch ran: the sub-block convs (centers given) or the plain conv.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.ops import pointwise_conv as jax_conv
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.utils.spatial import morton_sort_batch

op_mod = importlib.import_module("pointwise_torch.ops.pointwise_conv")


def morton_problem(seed, b=2, n=256, cin=5, cout=7, spread=1.0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-spread, spread, (b, n, 3)).astype(np.float32)
    return dict(points=morton_sort_batch(pts),
                features=rng.standard_normal((b, n, cin)).astype(np.float32),
                weights=(rng.standard_normal((27, cin, cout)) * 0.2).astype(
                    np.float32),
                bias=(rng.standard_normal(cout) * 0.1).astype(np.float32))


@pytest.fixture
def branches(monkeypatch):
    """Records, per top-level call, whether the sub-block convs ran."""
    seen = []
    orig = op_mod.pointwise_conv

    def spy(*args, **kw):
        if kw.get("centers") is not None:
            seen.append("sub")
        return orig(*args, **kw)

    monkeypatch.setattr(op_mod, "pointwise_conv", spy)
    return seen


def torch_run(p, requires_grad=False, **kw):
    t = {k: torch.from_numpy(v).requires_grad_(requires_grad
                                               and k != "points")
         for k, v in p.items()}
    y = pointwise_conv(t["points"], t["features"], t["weights"], t["bias"],
                       **kw)
    return y, t


def jax_run(p, **kw):
    j = {k: jnp.asarray(v) for k, v in p.items()}
    return jax_conv(j["points"], j["features"], j["weights"], j["bias"],
                    impl="reference", **kw)


def torch_grads(p, **kw):
    y, t = torch_run(p, requires_grad=True, **kw)
    (y ** 2).sum().backward()
    return [t[k].grad.numpy() for k in ("features", "weights", "bias")]


def jax_grads(p, **kw):
    def f(feats, w, b):
        y = jax_conv(jnp.asarray(p["points"]), feats, w, b,
                     impl="reference", **kw)
        return jnp.sum(y ** 2)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(p[k]) for k in ("features", "weights", "bias")))]


def test_subblock_matches_dense_fwd_and_grads(branches):
    p = morton_problem(31)
    kw = dict(radius=0.25)
    y_dense, _ = torch_run(p, **kw)
    y_sub, _ = torch_run(p, subblock=4, **kw)
    assert branches == ["sub"]
    np.testing.assert_allclose(y_sub.detach().numpy(),
                               y_dense.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y_sub.detach().numpy(),
                               np.asarray(jax_run(p, subblock=4, **kw)),
                               rtol=1e-5, atol=1e-5)
    g_dense, g_sub = torch_grads(p, **kw), torch_grads(p, subblock=4, **kw)
    for a, b in zip(g_dense, g_sub):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    for a, b in zip(jax_grads(p, subblock=4, **kw), g_sub):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_subblock_overflow_falls_back_dense(branches):
    # radius 2.5 >> the unit spread: every group's count is the full 256,
    # above the cap of 128 (32 rounded up), so the plain conv must run; a
    # wrongly taken sub-block branch would drop half of each neighborhood
    p = morton_problem(32)
    kw = dict(radius=2.5)
    y_dense, _ = torch_run(p, **kw)
    y_sub, _ = torch_run(p, subblock=4, subblock_cap=32, **kw)
    assert branches == []
    np.testing.assert_allclose(y_sub.detach().numpy(),
                               y_dense.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        y_sub.detach().numpy(),
        np.asarray(jax_run(p, subblock=4, subblock_cap=32, **kw)),
        rtol=1e-5, atol=1e-5)
    for a, b in zip(jax_grads(p, subblock=4, subblock_cap=32, **kw),
                    torch_grads(p, subblock=4, subblock_cap=32, **kw)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_subblock_reference_impl_matches_spec(branches):
    # subblock runs before the impl dispatch and forwards impl: the
    # gather / cap / fallback machinery checked against the executable spec
    p = morton_problem(34)
    kw = dict(radius=0.25, impl="reference")
    y_ref, _ = torch_run(p, **kw)
    y_sub, _ = torch_run(p, subblock=4, **kw)
    assert branches == ["sub"]
    np.testing.assert_allclose(y_sub.detach().numpy(), y_ref.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y_sub.detach().numpy(),
                               np.asarray(jax_run(p, subblock=4, radius=0.25)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_subblock_masked_rows(branches, precision):
    # masked candidates leak into no sub-block's neighborhoods, masked
    # centers output exact zeros: the dense path's contract
    p = morton_problem(33)
    mask = np.ones(p["points"].shape[:2], np.float32)
    mask[:, -40:] = 0.0
    kw = dict(radius=0.3, mask=torch.from_numpy(mask), precision=precision)
    y_dense, _ = torch_run(p, **kw)
    y_sub, _ = torch_run(p, subblock=4, **kw)
    assert branches == ["sub"]
    y_sub = y_sub.detach().numpy()
    np.testing.assert_allclose(y_sub, y_dense.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(y_sub[:, -40:]).max() == 0.0
    if precision == "float32":
        np.testing.assert_allclose(
            y_sub, np.asarray(jax_run(p, subblock=4, radius=0.3,
                                      mask=jnp.asarray(mask))),
            rtol=1e-5, atol=1e-5)


def test_subblock_refusals():
    p = morton_problem(35, n=96)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    args = (t["points"], t["features"], t["weights"])
    with pytest.raises(ValueError, match="must divide"):
        pointwise_conv(*args, radius=0.5, subblock=5)
    with pytest.raises(ValueError, match="self-convolution only"):
        pointwise_conv(*args, radius=0.5, subblock=2, centers=t["points"])
    with pytest.raises(ValueError, match="self-convolution only"):
        pointwise_conv(*args, radius=0.5, subblock=2,
                       ext_counts=torch.ones(2, 96, 27))
    # subblock=1 is the plain conv, as in the JAX op
    np.testing.assert_array_equal(
        pointwise_conv(*args, radius=0.5, subblock=1).numpy(),
        pointwise_conv(*args, radius=0.5).numpy())
