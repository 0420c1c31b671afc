"""Spatial parallelism of the port held against the JAX package on the CPU.

The same numpy-seeded problem goes through the JAX package's
``spatial_pointwise_conv`` under ``shard_map`` on the conftest's virtual CPU
devices (Pallas in interpret mode), and through the port's, on S ranks
spawned by ``pointwise_torch.parallel.launch`` (gloo, a FileStore in
``tmp_path``, one torch thread each, every collective bounded by 60 s and
each run by its own limit).  The ranks compute their slab's outputs and the
backward of sum(y * gdir); their feature gradients concatenate to the
global one and their weight and bias gradients sum to it.

Tolerances are the JAX package's own (tests/test_parallel.py): forward
2e-5, gradients 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pointwise_tpu.parallel import make_mesh as jax_mesh
from pointwise_tpu.parallel import spatial_pointwise_conv as jax_spatial
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.parallel import Mesh, launch, shard_batch

RUN_LIMIT = 180       # seconds for one spawned run, start to end


def make_problem(seed, b=2, n=64, cin=6, cout=8):
    rng = np.random.RandomState(seed)
    p = {"points": rng.uniform(-1, 1, (b, n, 3)).astype(np.float32),
         "features": rng.standard_normal((b, n, cin)).astype(np.float32),
         "weights": (rng.standard_normal((27, cin, cout)) * 0.2).astype(
             np.float32),
         "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32),
         "mask": (rng.rand(b, n) > 0.2).astype(np.float32)}
    gdir = rng.standard_normal((b, n, cout)).astype(np.float32)
    return p, gdir


def jax_run(p, gdir, S, strategy, radius):
    """JAX spatial conv on a (1 x S) mesh: y and the grads of
    psum(sum(y * gdir)) in features, weights and bias."""
    mesh = jax_mesh(data=1, space=S)
    pts, mask, g = (jnp.asarray(a) for a in (p["points"], p["mask"], gdir))
    spec = P(None, "space")

    def body(pt, m, gd, f, w, b):
        y = jax_spatial(pt, f, w, b, radius=radius, axis="space",
                        mask_local=m, strategy=strategy)
        return y, jax.lax.psum(jnp.sum(y * gd), "space")

    fn = jax.shard_map(body, mesh=mesh, check_vma=False,
                       in_specs=(spec, spec, spec, spec, P(), P()),
                       out_specs=(spec, P()))

    def loss(f, w, b):
        return fn(pts, mask, g, f, w, b)[1]

    args = [jnp.asarray(p[k]) for k in ("features", "weights", "bias")]
    y = np.asarray(jax.jit(fn)(pts, mask, g, *args)[0])
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return y, [np.asarray(x) for x in grads]


def torch_run(tmp_path, p, gdir, S, strategy, radius, probe=False):
    res = launch.spawn(launch.conv_worker, S, str(tmp_path), space=S,
                       timeout=RUN_LIMIT,
                       kwargs=dict(problem=p, gdir=gdir, radius=radius,
                                   strategy=strategy, probe=probe))
    y = torch.cat([r["y"] for r in res], 1).numpy()
    grads = [torch.cat([r["d_features"] for r in res], 1).numpy(),
             sum(r["d_weights"] for r in res).numpy(),
             sum(r["d_bias"] for r in res).numpy()]
    return y, grads, res


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("strategy", ["gather", "ring"])
@pytest.mark.parametrize("S", [2, 4])
def test_spatial_conv_and_grads_match_jax(tmp_path, S, strategy):
    p, gdir = make_problem(30 + S)
    want_y, want_g = jax_run(p, gdir, S, strategy, 0.5)
    y, grads, res = torch_run(tmp_path, p, gdir, S, strategy, 0.5)
    _close(y, want_y, 2e-5)
    for got, want in zip(grads, want_g):
        assert np.abs(want).max() > 0
        _close(got, want, 3e-5)
    # the single-device op agrees too, and masked slots get no gradient
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    single = pointwise_conv(t["points"], t["features"], t["weights"],
                            t["bias"], radius=0.5, mask=t["mask"]).numpy()
    _close(y, single, 2e-5)
    assert np.all(grads[0][p["mask"] == 0] == 0)
    # every rank sits where the mesh puts it: (0, r), one space group
    assert [r["coords"] for r in res] == [(0, r) for r in range(S)]
    assert all(r["space_ranks"] == list(range(S)) for r in res)
    assert [r["data_ranks"] for r in res] == [[r] for r in range(S)]


def test_ring_memory_bounded(tmp_path):
    """No conv kernel on a ring rank sees more than one slab of features
    (only the coordinates are gathered); the same probe sees the whole
    gathered set under the gather strategy, so it measures what it
    claims (the JAX package pins the same in tests/test_parallel.py)."""
    S, n = 4, 512
    p, gdir = make_problem(40, b=1, n=n)
    rows = {}
    for strategy in ("ring", "gather"):
        y, _, res = torch_run(tmp_path / strategy, p, gdir, S, strategy,
                                  0.3, probe=True)
        rows[strategy] = max(r["max_rows"] for r in res)
        t = {k: torch.from_numpy(v) for k, v in p.items()}
        single = pointwise_conv(t["points"], t["features"], t["weights"],
                                t["bias"], radius=0.3, mask=t["mask"])
        _close(y, single.numpy(), 2e-5)
    assert rows["ring"] <= n // S, rows
    assert rows["gather"] >= n, rows


def test_spatial_impl_refuses_what_jax_refuses():
    p, _ = make_problem(41)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    args = (t["points"], t["features"], t["weights"])
    with pytest.raises(ValueError, match="self-convolution only"):
        pointwise_conv(*args, radius=0.5, impl="spatial",
                       centers=t["points"])
    for bad in ({"csr": True}, {"center_mask": t["mask"]},
                {"ext_counts": torch.ones(2, 64, 27)}, {"subblock": 2}):
        with pytest.raises(ValueError, match="does not support"):
            pointwise_conv(*args, radius=0.5, impl="spatial:space:ring",
                           **bad)
    with pytest.raises(ValueError, match="unknown strategy"):
        pointwise_conv(*args, radius=0.5, impl="spatial:space:halo")
    with pytest.raises(ValueError, match="needs mesh="):
        pointwise_conv(*args, radius=0.5, impl="spatial")


def test_shard_batch_layout():
    # rank 3 of a 2 x 2 mesh: second batch half, second point half; labels
    # of rank 1 shard on B only
    mesh = Mesh(data=2, space=2, rank=3, backend="gloo",
                device=torch.device("cpu"), groups={})
    batch = {"points": torch.arange(4 * 6 * 3).reshape(4, 6, 3),
             "label": torch.arange(4)}
    out = shard_batch(mesh, batch)
    assert torch.equal(out["points"], batch["points"][2:, 3:])
    assert torch.equal(out["label"], batch["label"][2:])
    assert mesh.coords == (1, 1) and mesh.index("space") == 1
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, {"points": torch.zeros(3, 6, 3)})
