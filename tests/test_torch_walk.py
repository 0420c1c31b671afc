"""The tensor-core means walk's arithmetic, mirrored in plain PyTorch.

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

Tolerances: counts are integers and must be equal.  Sums: the mirror adds
the same exact products as the plain walk (0/1 x an exact bf16 term), per
16-candidate block first, so the two differ only by f32 rounding of sums of
at most a few hundred terms of |x| <= ~5: 1e-5 absolute and relative.  The
forward against JAX: f32 2e-5 (the JAX package's own tolerance for sums
taken in another order).
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
