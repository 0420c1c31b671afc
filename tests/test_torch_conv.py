"""The PyTorch port's pointwise conv held against the JAX package on the CPU.

Inputs are made from a seed with numpy and cross between the frameworks as
numpy arrays.  JAX runs as its own tests run it: the dense reference, or the
Pallas op in interpret mode.  The port runs ``impl='auto'`` on CPU tensors,
i.e. the plain PyTorch version of the CUDA kernel, in both walk modes.

Tolerances: f32 1e-4 (sums are taken in another order than the TPU
kernel's matmuls); bf16 2e-2 relative to max |y| (one bf16 ulp of a cell
mean can flip when an f32 sum lands on a rounding boundary).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.ops import pointwise_conv as jax_conv
from pointwise_tpu.ops import pointwise_conv_reference as jax_ref
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops import pointwise_conv, pointwise_conv_reference
from pointwise_torch.ops.pointwise_conv import conv_layout

# the package re-exports a function of the module's name
jk = importlib.import_module("pointwise_tpu.kernels.pointwise_conv_pallas")


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
    return p


def run_jax(fn, p, **kw):
    args = {k: jnp.asarray(v) for k, v in p.items()}
    return np.asarray(fn(args.pop("points"), args.pop("features"),
                         args.pop("weights"), args.pop("bias"), **args, **kw))


def run_torch(fn, p, **kw):
    args = {k: torch.from_numpy(v) for k, v in p.items()}
    return fn(args.pop("points"), args.pop("features"), args.pop("weights"),
              args.pop("bias"), **args, **kw).numpy()


def assert_close(got, want, precision):
    if precision == "bfloat16":
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
        assert err <= 2e-2, err
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


CASES = {
    "plain": dict(),
    "masked": dict(masked=True),
    "centers": dict(nc=53, masked=True),
    "n777": dict(n=777, masked=True),
}


@pytest.mark.parametrize("case", ["plain", "masked", "centers", "unbatched"])
def test_reference_matches_jax_reference(case):
    p = make_problem(0, **CASES.get(case, {}))
    if case == "unbatched":
        p = {k: (v[0] if v.ndim >= 2 and k != "weights" else v)
             for k, v in p.items()}
    want = run_jax(jax_ref, p, radius=0.5)
    got = run_torch(pointwise_conv_reference, p, radius=0.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_center_mask_defaults_to_mask_only_for_self_conv():
    # self-conv: center_mask defaults to mask (masked rows output 0);
    # explicit centers without center_mask: every center is live.
    p = make_problem(1, masked=True)
    y = run_torch(pointwise_conv, p, radius=0.5)
    assert np.all(y[p["mask"] == 0] == 0)
    want = run_jax(jax_conv, p, radius=0.5, impl="pallas")
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
    p2 = dict(p, centers=p["points"])
    y2 = run_torch(pointwise_conv, p2, radius=0.5)
    want2 = run_jax(jax_ref, p2, radius=0.5)
    np.testing.assert_allclose(y2, want2, rtol=1e-4, atol=1e-4)
    assert np.abs(y2[p["mask"] == 0]).max() > 0


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("case", ["masked", "centers", "n777"])
def test_op_matches_jax_pallas(case, csr, precision):
    p = make_problem(2, **CASES[case])
    kw = dict(radius=0.3, precision=precision, csr=csr)
    want = run_jax(jax_conv, p, impl="pallas", **kw)
    got = run_torch(pointwise_conv, p, impl="auto", **kw)
    assert got.shape == want.shape
    assert_close(got, want, precision)
    if "center_mask" in p:
        assert np.all(got[p["center_mask"] == 0] == 0)


@pytest.mark.parametrize("radius", [1.0, 2.0 ** 0.5, 2.0])
def test_plus_r_clamp_matches_jax(radius):
    # points on an exact grid: many pairs at exactly the radius and on cell
    # faces (cf. tests/test_edge_shapes.py::test_grid_aligned_points_boundary)
    g = np.stack(np.meshgrid(*([np.arange(3.0)] * 3)), -1).reshape(1, 27, 3)
    rng = np.random.RandomState(3)
    p = {"points": g.astype(np.float32),
         "features": rng.standard_normal((1, 27, 4)).astype(np.float32),
         "weights": (rng.standard_normal((27, 4, 4)) * 0.2).astype(np.float32),
         "bias": np.zeros(4, np.float32)}
    want_ref = run_jax(jax_ref, p, radius=radius)
    np.testing.assert_allclose(run_torch(pointwise_conv_reference, p,
                                         radius=radius),
                               want_ref, rtol=1e-5, atol=1e-5)
    want = run_jax(jax_conv, p, radius=radius, impl="pallas")
    for csr in (False, True):
        got = run_torch(pointwise_conv, p, radius=radius, csr=csr)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_walk_modes_identical_and_counts_exact():
    # The CSR list only drops tiles without in-ball pairs and both walks add
    # in ascending candidate order: identical bits, and counts equal to
    # brute-force binning.
    p = make_problem(4, b=2, n=700, masked=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    r = 0.25
    outs = []
    for csr in (False, True):
        kw, _ = conv_layout(t["points"], t["features"], t["weights"],
                            t["bias"], radius=r, mask=t["mask"], csr=csr)
        assert (kw["tile_idx"] is not None) == csr
        outs.append(tk.conv_fwd(**kw))
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    pts = np.where(p["mask"][..., None] > 0, p["points"], tk.SENTINEL)
    rel = pts[:, None, :, :] - pts[:, :, None, :]
    valid = (rel ** 2).sum(-1) <= r * r
    c = np.clip(np.floor((rel + r) * (3.0 / (2 * r))), 0, 2)
    cell = (c[..., 0] * 9 + c[..., 1] * 3 + c[..., 2]).astype(int)
    want = (np.eye(27)[cell] * valid[..., None]).sum(axis=2)
    got = outs[1][1].numpy()[:, :700]
    live = p["mask"] > 0
    np.testing.assert_array_equal(got[live], want[live])


@pytest.mark.parametrize("seed", [0, 1])
def test_adjacency_matches_jax(seed):
    rng = np.random.RandomState(seed)
    b, n, m, r = 2, 1024, 1536, 0.15
    ctr = rng.uniform(0, 2, (b, n, 3)).astype(np.float32)
    pts = rng.uniform(0, 2, (b, m, 3)).astype(np.float32)
    ctr = np.sort(ctr, axis=1)          # sort along x-ish for compact tiles
    pts = np.sort(pts, axis=1)
    pts[:, -100:] = tk.SENTINEL         # sentinel padding is ignored
    ctr[:, -64:] = -tk.SENTINEL
    tile = tk.TILE
    lo_r, hi_r = jk._row_tile_boxes(jnp.asarray(ctr), tile)
    lo_c, hi_c = jk._col_tile_boxes(jnp.swapaxes(jnp.asarray(pts), 1, 2),
                                    tile)
    n_c = m // tile
    jm_j, deg_j, _ = jk._boxes_adjacency(r, n_c, lo_r, hi_r, lo_c, hi_c,
                                         density_gate=False)
    ptr_t, idx_t = tk.tile_adjacency(torch.from_numpy(ctr),
                                     torch.from_numpy(pts), r)
    ptr_t, idx_t = ptr_t.numpy(), idx_t.numpy()
    deg_j = np.asarray(deg_j)
    np.testing.assert_array_equal(np.diff(ptr_t).reshape(b, n // tile), deg_j)
    assert ptr_t[0] == 0 and ptr_t[-1] == len(idx_t)
    assert 0 < deg_j.max() < n_c        # neither empty nor complete
    jm_j = np.asarray(jm_j)
    for bi in range(b):
        for row in range(n // tile):
            i = bi * (n // tile) + row
            mine = idx_t[ptr_t[i]:ptr_t[i + 1]]
            assert set(mine) == set(jm_j[bi, row, :deg_j[bi, row]])
            assert list(mine) == sorted(mine)


def test_not_yet_ported_options_raise():
    # every option is ported (subblock: tests/test_torch_subblock.py;
    # ext_counts, pointwise_conv_counts and the spatial impls:
    # tests/test_torch_counts.py, test_torch_spatial.py); each refuses what
    # the JAX op refuses
    p = {k: torch.from_numpy(v) for k, v in make_problem(5).items()}
    args = (p["points"], p["features"], p["weights"])
    with pytest.raises(ValueError, match="self-convolution only"):
        pointwise_conv(*args, radius=0.5, subblock=2, centers=p["points"])
    with pytest.raises(ValueError, match="must divide"):
        pointwise_conv(*args, radius=0.5, subblock=5)
    with pytest.raises(ValueError, match="partial convolution"):
        pointwise_conv(*args, p["bias"], radius=0.5,
                       ext_counts=torch.ones(2, 96, 27))
    with pytest.raises(ValueError, match="self-convolution only"):
        pointwise_conv(*args, radius=0.5, impl="spatial",
                       centers=p["points"])
    with pytest.raises(ValueError, match="weights must be"):
        pointwise_conv(p["points"], p["features"], p["weights"][:, :3],
                       radius=0.5)


def test_coordinate_guard_is_opt_in():
    p = {k: torch.from_numpy(v) for k, v in make_problem(6).items()}
    far = p["points"].clone()
    far[0, 0, 0] = 6.0e5
    pointwise_conv(far, p["features"], p["weights"], radius=0.5)
    with pytest.raises(ValueError, match="5e5"):
        pointwise_conv(far, p["features"], p["weights"], radius=0.5,
                       validate=True)
    # a masked far point is padding, not an error
    mask = torch.ones(far.shape[:2])
    mask[0, 0] = 0
    pointwise_conv(far, p["features"], p["weights"], radius=0.5, mask=mask,
                   validate=True)


def test_cuda_wrapper_checks_inputs():
    # the wrapper's checks run before any device or library is touched
    p = {k: torch.from_numpy(v) for k, v in make_problem(7).items()}
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=0.5)
    with pytest.raises(TypeError, match="share"):
        tk.conv_fwd(**dict(kw, w=kw["w"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="multiples"):
        tk.conv_fwd(**dict(kw, pts=kw["pts"][:, :100], feats=kw["feats"][:, :100]))
    with pytest.raises(ValueError, match="together"):
        tk.conv_fwd(**dict(kw, tile_ptr=torch.zeros(1, dtype=torch.int32)))
