"""The tensor-core kernels' arithmetic, mirrored in plain PyTorch.

The forward and dW kernels sum each cell's features as 0/1 cell planes times
the feature rows on tensor cores (csrc/pointwise_conv_walk.cuh).  The card
alone runs them; here ``mirror_walk`` repeats their arithmetic step for
step: per 16 centers, the listed 64-candidate tiles in ascending order, per
16 x 16 block the cells with no pair skipped, the exact 0/1 plane times the
bf16 feature terms (three in f32 mode: hi, mid, lo) accumulated in f32, and
the counts as the plane's sums (the kernel's column of ones).  It is held to
the kernel module's plain walk (``_cell_sums_plain``), whose counts
``conv_counts`` equals bit for bit on the card, and, through the product,
to the JAX package's Pallas op in interpret mode.

dX's walk (tag DxSums) is the same walk with candidates as rows and the
centers of the transposed tile list as columns; ``mirror_dx_walk`` repeats
it: per 16 candidates and 16 x 16 block, each cell's plane with its ones
replaced by the column's scale round(1/max(cnt, 1)), times round(g) (in f32
mode three bf16 terms of each, nine exact products), accumulated in f32.
It is held to ``_dx_sums_plain``, the f32 sums that ``conv_dx_sums_plain``
rounds.  ``mirror_dw_product`` repeats dW's tensor-core product: the
slices of the centers of ``dw_product_plan``, 16-center k-steps (the k16
MMAs) of xbar^T . round(g) in f32, the slices added in ascending order.

Tolerances: counts are integers and must be equal.  Sums: the mirror adds
the same exact products as the plain walk (0/1 x an exact bf16 term, or in
dX a bf16 scale x a bf16 term), per 16-candidate block first, so the two
differ only by f32 rounding of sums of at most a few hundred terms of |x|
<= ~5: 1e-5 absolute and relative (for dW's product relative to max |dW|,
a sum over every center).  The forward against JAX: f32 2e-5 (the JAX
package's own tolerance for sums taken in another order); dX against
``jax.vjp``: tests/test_torch_grad.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointwise_tpu.ops import pointwise_conv as jax_conv
from pointwise_torch.data import synthetic
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.ops.pointwise_conv import conv_layout
from pointwise_torch.utils.spatial import morton_sort

WALK_M = 16      # centers per walk CTA
K_STEP = 16      # candidates per MMA k-step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split3(x):
    """f32 -> three bf16 terms, hi = rn(x), mid = rn(x - hi), lo = rn(x -
    hi - mid): the walk's pack kernel in f32 mode."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def mirror_walk(ctr, pts, feats, radius, tile_ptr=None, tile_idx=None):
    """(sums (B, Ncp, 27, Cin) f32, counts (B, Ncp, 27) f32) as the kernel
    forms them: 16 centers at a time, each listed candidate tile in order,
    per 16 x 16 block only the cells it holds, plane x terms in f32."""
    B, Ncp, _ = ctr.shape
    Mp, cin = pts.shape[1], feats.shape[2]
    terms = [t.float() for t in (split3(feats) if feats.dtype == torch.float32
                                 else (feats,))]
    sums = torch.zeros((B, Ncp, 27, cin))
    cnt = torch.zeros((B, Ncp, 27))
    n_rows = Ncp // tk.TILE
    ptr = None if tile_ptr is None else tile_ptr.tolist()
    cells = torch.arange(27)[:, None, None]
    for b in range(B):
        for row in range(n_rows):
            if ptr is None:
                tiles = range(Mp // tk.TILE)
            else:
                i = b * n_rows + row
                tiles = tile_idx[ptr[i]:ptr[i + 1]].tolist()
            for m0 in range(row * tk.TILE, (row + 1) * tk.TILE, WALK_M):
                c = ctr[b, m0:m0 + WALK_M]
                acc = torch.zeros((27, WALK_M, cin))
                n = torch.zeros((27, WALK_M))
                for jt in tiles:
                    for j0 in range(jt * tk.TILE, (jt + 1) * tk.TILE, K_STEP):
                        q = pts[b, j0:j0 + K_STEP]
                        code, ok = tk._pair_codes(q[None] - c[:, None],
                                                  radius)
                        code = torch.where(ok, code, torch.full_like(code,
                                                                     255))
                        plane = (code[None] == cells).float()  # (27, 16, 16)
                        live = plane.flatten(1).any(1).nonzero()[:, 0]
                        for t in terms:          # empty cells skipped
                            acc[live] += plane[live] @ t[b, j0:j0 + K_STEP]
                        n[live] += plane[live].sum(-1)
                sums[b, m0:m0 + WALK_M] = acc.transpose(0, 1)
                cnt[b, m0:m0 + WALK_M] = n.T
    return sums, cnt


def crafted_grid(radius, origin, n=7):
    """n^3 points on a grid of spacing r/3 (dyadic r): many pairs at exactly
    the radius and exactly on cell faces."""
    s = np.float32(radius / 3.0)
    g = np.stack(np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3)), -1)
    return (g.reshape(-1, 3) * s + np.float32(origin)).astype(np.float32)


def scene(seed, cin, radius, b=2, n_scene=260):
    """Morton-sorted scene crops with a crafted grid at exactly r, masks,
    and centers != candidates."""
    rng = np.random.RandomState(seed)
    xyz, _, _ = synthetic.segmentation_scene(seed, num_objects=3,
                                             points_per_obj=512, room=1.5)
    grid = crafted_grid(radius, (0.5, 0.5, 0.25), n=5)
    clouds = np.stack([
        morton_sort(np.concatenate(
            [xyz[rng.choice(len(xyz), n_scene, replace=False)], grid]))
        for _ in range(b)])
    n = clouds.shape[1]
    nc = (3 * n) // 4
    ctr = np.stack([c[np.sort(rng.choice(n, nc, replace=False))]
                    for c in clouds])
    t = torch.from_numpy
    return dict(points=t(clouds),
                features=t(rng.standard_normal((b, n, cin)).astype(
                    np.float32)),
                weights=t((rng.standard_normal((27, cin, 9))
                           / np.sqrt(27 * cin)).astype(np.float32)),
                bias=t((rng.standard_normal(9) * 0.1).astype(np.float32)),
                mask=t((rng.rand(b, n) > 0.1).astype(np.float32)),
                centers=t(ctr),
                center_mask=t((rng.rand(b, nc) > 0.1).astype(np.float32)))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("cin", [3, 6, 124])
def test_mirror_matches_plain_walk(cin, csr, precision):
    radius = 0.375
    p = scene(cin, cin, radius)
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=radius, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], precision=precision,
                        csr=csr)
    walk = (kw["ctr"], kw["pts"], kw["feats"], radius, kw["tile_ptr"],
            kw["tile_idx"])
    sums, cnt = mirror_walk(*walk)
    sums_p, cnt_p = tk._cell_sums_plain(*walk)
    assert torch.equal(cnt, cnt_p)
    assert cnt.sum() > 0 and (cnt > 1).any()
    # pairs at exactly r and on cell faces are in the inputs
    assert torch.equal(cnt, tk.conv_counts_plain(*walk[:2], radius,
                                                 *walk[4:]))
    torch.testing.assert_close(sums, sums_p, rtol=1e-5, atol=1e-5)


def all_cells_block(cin=5, seed=0):
    """(ctr, pts, feats) of one 64 x 64 tile pair whose first 16 x 16 block
    holds pairs of all 27 cells: 16 candidates on the 3 x 3 x 3 offset grid
    (spacing 0.4, r = 0.75: one offset per cell) and 3 centers shifted by
    0, 0.4 and 0.8 along x, so that the other 11 cells show up too; the
    rest is sentinel padding."""
    offs = np.array([(x, y, z) for x in (-0.4, 0.0, 0.4)
                     for y in (-0.4, 0.0, 0.4) for z in (-0.4, 0.0, 0.4)],
                    np.float32)
    pts = np.full((1, tk.TILE, 3), tk.SENTINEL, np.float32)
    pts[0, :16] = offs[:16]
    ctr = np.full((1, tk.TILE, 3), -tk.SENTINEL, np.float32)
    ctr[0, :3] = [(0.0, 0.0, 0.0), (-0.4, 0.0, 0.0), (-0.8, 0.0, 0.0)]
    feats = np.random.RandomState(seed).standard_normal(
        (1, tk.TILE, cin)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (ctr, pts, feats))


def test_mirror_skips_no_cell_of_a_block_that_holds_all_27():
    walk = (*all_cells_block(), 0.75, None, None)
    sums, cnt = mirror_walk(*walk)
    sums_p, cnt_p = tk._cell_sums_plain(*walk)
    assert torch.equal(cnt, cnt_p)
    assert bool((cnt[0, :3].sum(0) > 0).all())      # all 27 cells
    torch.testing.assert_close(sums, sums_p, rtol=1e-5, atol=1e-5)


def test_three_term_split_is_exact():
    rng = np.random.RandomState(3)
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.randint(-20, 20, 4096),
        [0.0, -0.0, 1.0, -1.0, 1 / 3, np.pi, 65504.0, 1e-30, 3.38e38]])
    # (exact while hi stays finite: |x| up to bf16's largest, 3.39e38)
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = split3(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # each term holds what the one before could not
    assert bool((mid.double().abs() <= hi.double().abs()).all())
    assert bool((lo.double().abs() <= mid.double().abs()).all())


def test_mirror_forward_matches_jax():
    # the mirror's means through the product equal the JAX op's forward
    radius, cin = 0.375, 6
    p = scene(11, cin, radius, b=1)
    kw, (n, nc, _) = conv_layout(
        p["points"], p["features"], p["weights"], p["bias"], radius=radius,
        mask=p["mask"], centers=p["centers"], center_mask=p["center_mask"],
        precision="float32", csr=True)
    sums, cnt = mirror_walk(kw["ctr"], kw["pts"], kw["feats"], radius,
                            kw["tile_ptr"], kw["tile_idx"])
    xbar = (sums / torch.clamp_min(cnt, 1.0)[..., None]).reshape(-1, 27 * cin)
    y = tk.conv_fwd_product_plain(xbar, kw["w"], kw["bias"]).reshape(
        1, -1, 9)[:, :nc].numpy()
    want = np.asarray(jax_conv(
        *(jnp.asarray(p[k].numpy()) for k in ("points", "features",
                                               "weights", "bias")),
        radius=radius, mask=jnp.asarray(p["mask"].numpy()),
        centers=jnp.asarray(p["centers"].numpy()),
        center_mask=jnp.asarray(p["center_mask"].numpy()),
        impl="pallas", precision="float32"))
    np.testing.assert_allclose(y * p["center_mask"].numpy()[..., None], want,
                               rtol=2e-5, atol=2e-5)


def test_means_and_product_compose_to_the_forward():
    # the CPU path of the two wrappers is the plain forward, bit for bit,
    # and launches nothing
    p = scene(5, 124, 0.375, b=1)
    for precision in ("float32", "bfloat16"):
        kw, _ = conv_layout(p["points"], p["features"], p["weights"],
                            p["bias"], radius=0.375, mask=p["mask"],
                            precision=precision, csr=True)
        tk.reset_launches()
        xbar, cnt = tk.conv_fwd_means(kw["ctr"], kw["pts"], kw["feats"],
                                      0.375, kw["tile_ptr"], kw["tile_idx"])
        y = tk.conv_fwd_product(xbar, kw["w"], kw["bias"])
        want, cnt_w = tk.conv_fwd_plain(**kw)
        assert xbar.dtype == kw["feats"].dtype
        assert xbar.shape == (kw["ctr"].shape[1], 27 * 124)
        assert torch.equal(cnt, cnt_w)
        assert torch.equal(y.view(want.shape), want)
        assert sum(tk.LAUNCHES.values()) == 0


def mirror_dx_walk(ctr, pts, g, cnt, radius, tile_ptr=None, tile_idx=None,
                   dtype=torch.float32):
    """dX's sums Z (B, Mp, 27, Cout) f32 as the kernel forms them: 16
    candidates at a time, each listed center tile in order, per 16 x 16
    block only the cells it holds, the scaled plane's terms times g's
    terms in f32."""
    B, Ncp, _ = ctr.shape
    Mp, cout = pts.shape[1], g.shape[2]
    s = 1.0 / torch.clamp_min(cnt, 1.0)          # divided in f32
    if dtype == torch.float32:
        s_terms, g_terms = split3(s), split3(g)
    else:
        s_terms, g_terms = (s.to(dtype),), (g.to(dtype),)
    s_terms = [t.float() for t in s_terms]
    g_terms = [t.float() for t in g_terms]
    z = torch.zeros((B, Mp, 27, cout))
    n_rows = Mp // tk.TILE
    ptr = None if tile_ptr is None else tile_ptr.tolist()
    cells = torch.arange(27)[:, None, None]
    for b in range(B):
        for row in range(n_rows):
            if ptr is None:
                tiles = range(Ncp // tk.TILE)
            else:
                i = b * n_rows + row
                tiles = tile_idx[ptr[i]:ptr[i + 1]].tolist()
            for m0 in range(row * tk.TILE, (row + 1) * tk.TILE, WALK_M):
                q = pts[b, m0:m0 + WALK_M]
                acc = torch.zeros((27, WALK_M, cout))
                for it in tiles:
                    for j0 in range(it * tk.TILE, (it + 1) * tk.TILE, K_STEP):
                        c = ctr[b, j0:j0 + K_STEP]
                        # pair_code(candidate, center): the row's candidate
                        code, ok = tk._pair_codes(q[:, None] - c[None],
                                                  radius)
                        code = torch.where(ok, code,
                                           torch.full_like(code, 255))
                        on = code[None] == cells             # (27, 16, 16)
                        live = on.flatten(1).any(1).nonzero()[:, 0]
                        for st in s_terms:               # empty cells skipped
                            plane = on[live] * st[b, j0:j0 + K_STEP,
                                                  live].T[:, None, :]
                            for gt in g_terms:
                                acc[live] += plane @ gt[b, j0:j0 + K_STEP]
                z[b, m0:m0 + WALK_M] = acc.transpose(0, 1)
    return z


def dx_inputs(p, radius, precision, csr, seed=0):
    """(ctr, pts, g, cnt, radius, transposed list) of a scene: the
    forward's counts, g from a numpy seed, the candidate-tile -> center-tile
    list for the CSR walk."""
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=radius, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], precision=precision,
                        csr=csr)
    cnt = tk.conv_counts_plain(kw["ctr"], kw["pts"], radius, kw["tile_ptr"],
                               kw["tile_idx"])
    g = torch.from_numpy(np.random.RandomState(seed).standard_normal(
        (*kw["ctr"].shape[:2], p["weights"].shape[2])).astype(np.float32))
    ptr_t = idx_t = None
    if csr:
        ptr_t, idx_t = tk.tile_adjacency(kw["pts"], kw["ctr"], radius)
    return kw, (kw["ctr"], kw["pts"], g, cnt, radius, ptr_t, idx_t)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("cout", [6, 124])
def test_dx_mirror_matches_plain_sums(cout, csr, precision):
    radius = 0.375
    p = scene(20 + cout, 5, radius)
    p["weights"] = torch.zeros((27, 5, cout))       # only its width is read
    _, args = dx_inputs(p, radius, precision, csr, seed=cout)
    dtype = getattr(torch, precision)
    z = mirror_dx_walk(*args, dtype=dtype)
    z_p = tk._dx_sums_plain(*args, dtype)
    assert bool((args[3] > 1).any()) and z_p.abs().max() > 0
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-5)
    # the plain version's output is those sums rounded to the matmul type
    assert torch.equal(tk.conv_dx_sums_plain(*args, dtype),
                       z_p.to(dtype).reshape(z_p.shape[0] * z_p.shape[1], -1))


def test_dx_mirror_skips_no_cell_of_a_block_that_holds_all_27():
    # the forward's all-cells block with the roles swapped: 3 candidates
    # as rows, the 16 offsets (negated) as center columns, the same rel
    ctr, pts, _ = all_cells_block()
    pts2 = torch.full_like(pts, tk.SENTINEL)
    pts2[0, :3] = -ctr[0, :3]
    ctr2 = torch.full_like(ctr, -tk.SENTINEL)
    ctr2[0, :16] = -pts[0, :16]
    cnt = tk.conv_counts_plain(ctr2, pts2, 0.75)
    g = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (1, tk.TILE, 7)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        args = (ctr2, pts2, g, cnt, 0.75, None, None)
        z = mirror_dx_walk(*args, dtype=dtype)
        z_p = tk._dx_sums_plain(*args, dtype)
        assert bool((z_p[0, :3].abs().sum((0, 2)) > 0).all())   # all 27
        torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-5)


def test_three_term_split_of_the_scales_is_exact():
    # f32 mode's scales 1/max(cnt, 1), divided in f32 as the kernel does
    x = 1.0 / torch.arange(1, 4097, dtype=torch.float32)
    hi, mid, lo = split3(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


def mirror_dw_product(xbar, g):
    """dW (27, Cin, Cout) as the tensor-core product forms it: the rows in
    ``dw_product_plan``'s slices (the same on any card: 132 SMs or 114),
    each slice's 16-row k-steps of xbar^T . round(g) accumulated in f32,
    the slices added in ascending order."""
    rows, k = xbar.shape
    cout = g.shape[1]
    plan = tk.dw_product_plan(rows, k, cout, 132)
    assert plan == dict(tk.dw_product_plan(rows, k, cout, 114),
                        grid=plan["grid"])
    splits, chunk = plan["slices"], plan["chunk"]
    x, gb = xbar.float(), g.to(xbar.dtype).float()
    total = None
    for s in range(splits):
        part = torch.zeros((k, cout))
        for n0 in range(s * chunk, min((s + 1) * chunk, rows), K_STEP):
            part += x[n0:n0 + K_STEP].T @ gb[n0:n0 + K_STEP]
        total = part if total is None else total + part
    return total.reshape(27, k // 27, cout), splits


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_dw_product_mirror_matches_plain(csr, precision):
    radius, cin = 0.375, 124
    p = scene(30, cin, radius)
    kw, _ = conv_layout(p["points"], p["features"], p["weights"], p["bias"],
                        radius=radius, mask=p["mask"], centers=p["centers"],
                        center_mask=p["center_mask"], precision=precision,
                        csr=csr)
    _, cnt = tk.conv_fwd_plain(**kw)
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (*kw["ctr"].shape[:2], 9)).astype(np.float32))
    walk = (kw["ctr"], kw["pts"], kw["feats"], g, cnt, radius,
            kw["tile_ptr"], kw["tile_idx"])
    xbar = tk.conv_dw_means_plain(*walk[:3], cnt, radius, *walk[6:])
    dw, splits = mirror_dw_product(xbar, g.reshape(-1, 9))
    want = tk.conv_dw_plain(*walk)
    assert splits > 1                      # the split-K reduce is exercised
    torch.testing.assert_close(dw, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_wrappers_compose_to_the_plain_gradients():
    # the CPU path of dW's and dX's two wrappers each is the plain gradient,
    # bit for bit, and launches nothing
    radius = 0.375
    p = scene(6, 124, radius, b=1)
    for precision in ("float32", "bfloat16"):
        kw, args = dx_inputs(p, radius, precision, True, seed=3)
        ctr, pts, g, cnt, _, ptr_t, idx_t = args
        tk.reset_launches()
        xbar = tk.conv_dw_means(ctr, pts, kw["feats"], cnt, radius,
                                kw["tile_ptr"], kw["tile_idx"])
        dw = tk.conv_dw_product(xbar, g.reshape(-1, g.shape[2]))
        z = tk.conv_dx_sums(*args, dtype=kw["w"].dtype)
        dx = tk.conv_dx_product(z, kw["w"])
        assert xbar.dtype == z.dtype == kw["w"].dtype
        assert z.shape == (pts.shape[1], 27 * 9)
        assert torch.equal(dw, tk.conv_dw_plain(
            ctr, pts, kw["feats"], g, cnt, radius, kw["tile_ptr"],
            kw["tile_idx"]))
        assert torch.equal(dx.view(1, -1, 124), tk.conv_dx_plain(
            ctr, pts, g, cnt, kw["w"], radius, ptr_t, idx_t))
        assert sum(tk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_dx_sums_and_product_match_jax_vjp(precision):
    # conv_dx_sums_plain then the product: the feature gradient of the JAX
    # op (Pallas, interpret mode) under the same cotangent
    radius, cin = 0.375, 6
    p = scene(12, cin, radius, b=1)
    kw, (_, nc, _) = conv_layout(
        p["points"], p["features"], p["weights"], p["bias"], radius=radius,
        mask=p["mask"], centers=p["centers"], center_mask=p["center_mask"],
        precision=precision, csr=True)
    n = p["points"].shape[1]
    gdir = np.random.RandomState(4).standard_normal((1, nc, 9)).astype(
        np.float32)
    g = torch.zeros((1, kw["ctr"].shape[1], 9))
    g[:, :nc] = torch.from_numpy(gdir) * p["center_mask"][..., None]
    _, cnt = tk.conv_fwd_plain(**kw)
    ptr_t, idx_t = tk.tile_adjacency(kw["pts"], kw["ctr"], radius)
    z = tk.conv_dx_sums_plain(kw["ctr"], kw["pts"], g, cnt, radius, ptr_t,
                              idx_t, kw["w"].dtype)
    got = tk.conv_dx_product_plain(z, kw["w"]).reshape(1, -1, cin)[:, :n]
    j = {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    def f(x):
        return jax_conv(j["points"], x, j["weights"], j["bias"],
                        radius=radius, mask=j["mask"], centers=j["centers"],
                        center_mask=j["center_mask"], impl="pallas",
                        precision=precision)

    _, vjp = jax.vjp(f, j["features"])
    want = np.asarray(vjp(jnp.asarray(gdir))[0])
    scale = float(np.abs(want).max())
    assert scale > 0
    if precision == "bfloat16":
        assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * scale
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)

