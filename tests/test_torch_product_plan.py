"""The host side of the bf16 product kernel (csrc/pointwise_conv_product.cuh)
on the CPU: the tile plan the wrapper hands the kernel (N tile from n, row
tile, stages and shared memory from the N tile, the persistent grid from
the rows and the SM count, W's L2 bytes), dW's plan (the same tile rule,
the centers' slices the same on every card, covering every row once), the
B operand it lays out (W per cell, K-major) and the ptxas report reader;
and the product timing tool's CPU path.  The kernel itself runs only on
the card (tests/test_torch_cuda.py::test_product_kernel and
::test_dw_product_kernel).
"""

import numpy as np
import pytest
import torch

from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.tools import time_products

_BLOCK_SMEM = 232_448      # dynamic shared memory one block may use on sm_90


@pytest.mark.parametrize("n,bn,n_tiles", [
    (1, 8, 1), (3, 8, 1), (8, 8, 1), (9, 16, 1), (6, 8, 1), (64, 64, 1),
    (65, 128, 1), (124, 128, 1), (128, 128, 1), (129, 256, 1),
    (256, 256, 1), (300, 256, 2), (1024, 256, 4)])
def test_n_tile_from_n(n, bn, n_tiles):
    plan = tk.product_plan(64, n, 27 * 124, 132)
    assert (plan["bn"], plan["n_tiles"]) == (bn, n_tiles)
    assert plan["bn"] in tk.PRODUCT_BN


@pytest.mark.parametrize("bn", tk.PRODUCT_BN)
def test_row_tile_stages_and_shared_memory(bn):
    plan = tk.product_plan(64, bn, 81, 132)
    # two consumer warpgroups of one or two m64 sub-tiles each: 128
    # accumulators a thread at most
    assert plan["bm"] == (256 if bn <= 128 else 128)
    assert plan["bm"] * bn // 256 <= 128
    stage = (plan["bm"] + bn) * 64 * 2
    assert 4 <= plan["stages"] <= 8
    assert plan["stages"] * stage <= 230_400 < (plan["stages"] + 1) * stage \
        or plan["stages"] == 8
    assert plan["smem"] == 1024 + plan["stages"] * (stage + 16)
    assert plan["smem"] <= _BLOCK_SMEM
    assert plan["cluster"] == 1


@pytest.mark.parametrize("rows,n,sms", [
    (64, 124, 132), (64 * 37, 124, 132), (32_768, 124, 132),
    (229_376, 124, 132), (229_376, 124, 114), (2368, 1024, 132),
    (64, 3, 132), (65_536, 64, 132)])
def test_grid_and_l2_bytes_from_rows(rows, n, sms):
    k = 27 * 124
    plan = tk.product_plan(rows, n, k, sms)
    assert plan["row_tiles"] == -(-rows // plan["bm"])
    assert plan["tiles"] == plan["row_tiles"] * plan["n_tiles"]
    assert plan["grid"] == min(plan["tiles"], sms) >= 1
    assert plan["k_steps"] == -(-k // 64)
    # every row tile reads all of W once, every N tile all of A
    assert plan["w_l2_bytes"] == plan["row_tiles"] * k * n * 2
    assert plan["a_l2_bytes"] == plan["n_tiles"] * rows * k * 2


def test_main_path_plans():
    # the forward's product at layer 1 of the 1M-point request and dX's at
    # a segmentation step, 124 wide, on the 132 SMs of an H100
    fwd = tk.product_plan(229_376, 124, 3348, 132)
    assert (fwd["bm"], fwd["bn"], fwd["stages"], fwd["tiles"],
            fwd["grid"]) == (256, 128, 4, 896, 132)
    assert fwd["w_l2_bytes"] == 743_952_384      # a 64-row tile: 3.07e9
    dx = tk.product_plan(32_768, 124, 3348, 132)
    assert (dx["tiles"], dx["grid"], dx["w_l2_bytes"]) == (128, 128,
                                                          106_278_912)


DW_SHAPES = [(64, 3, 3), (64, 6, 124), (64 * 37, 124, 124),
             (64 * 37 + 64 * 9, 1024, 1024), (8 * 2048, 124, 124),
             (32 * 1024, 6, 124), (32 * 1024, 124, 124),
             (64 * 1024, 64, 64), (32 * 4096, 124, 124), (4096, 3, 1024)]


@pytest.mark.parametrize("rows,cin,cout", DW_SHAPES)
def test_dw_plan_is_the_same_on_every_card(rows, cin, cout):
    # the slices (and so dW's bits) never depend on the SM count; only the
    # persistent grid does
    k = 27 * cin
    plans = [tk.dw_product_plan(rows, k, cout, sms)
             for sms in (1, 16, 78, 114, 132, 144, 1000)]
    for sms, plan in zip((1, 16, 78, 114, 132, 144, 1000), plans):
        assert plan["grid"] == min(plan["units"], sms) >= 1
        assert {key: v for key, v in plan.items() if key != "grid"} \
            == {key: v for key, v in plans[0].items() if key != "grid"}


@pytest.mark.parametrize("cout", [1, 3, 8, 9, 64, 124, 128, 129, 256, 300,
                                  1024])
@pytest.mark.parametrize("cin", [3, 6, 64, 124, 1024])
def test_dw_plan_tile_and_shared_memory(cin, cout):
    # dW's rows (27 * Cin) take the forward's tile rule by n = Cout, so the
    # kernel's shared memory stays under the 227 KB a block may use
    k = 27 * cin
    plan = tk.dw_product_plan(64 * 37, k, cout, 132)
    tile = tk.product_plan(k, cout, 64 * 37, 132)
    for key in ("bm", "bn", "stages", "smem", "tiles"):
        assert plan[key] == tile[key]
    assert plan["smem"] <= _BLOCK_SMEM
    assert plan["tiles"] == -(-k // plan["bm"]) * -(-cout // plan["bn"])


@pytest.mark.parametrize("rows,cin,cout", DW_SHAPES)
def test_dw_slices_cover_every_row_once(rows, cin, cout):
    plan = tk.dw_product_plan(rows, 27 * cin, cout, 132)
    chunk, slices = plan["chunk"], plan["slices"]
    assert chunk % 64 == 0 and plan["k_steps"] == -(-rows // 64)
    seen = np.zeros(rows, np.int64)
    for s in range(slices):
        beg, end = s * chunk, min((s + 1) * chunk, rows)
        assert end > beg                       # no empty slice
        seen[beg:end] += 1
    assert (seen == 1).all() and slices * chunk >= rows > (slices - 1) * chunk
    assert plan["units"] == plan["tiles"] * slices
    # as many slices as fit the fixed unit target, at most one a k-step
    assert slices <= plan["k_steps"]
    assert plan["units"] <= tk.DW_UNITS or slices == 1
    assert plan["part_bytes"] == (slices * 27 * cin * cout * 4
                                  if slices > 1 else 0)


def test_dw_main_path_plans():
    # dW's product at a segmentation step (8 x 4096 centers; ModelNet's
    # 32 x 1024 the same), its first layer, ShapeNetPart's 8 x 2048 and
    # the 64-wide conv: one wave of at most 132 units
    def key(rows, cin, cout):
        p = tk.dw_product_plan(rows, 27 * cin, cout, 132)
        return (p["bm"], p["bn"], p["stages"], p["tiles"], p["slices"],
                p["chunk"], p["units"], p["grid"])
    assert key(32_768, 124, 124) == (256, 128, 4, 14, 9, 3648, 126, 126)
    assert key(32_768, 6, 124) == (256, 128, 4, 1, 128, 256, 128, 128)
    assert key(16_384, 124, 124) == (256, 128, 4, 14, 9, 1856, 126, 126)
    assert key(65_536, 64, 64) == (256, 64, 5, 7, 18, 3648, 126, 126)
    assert tk.dw_product_plan(32_768, 3348, 124, 132)["part_bytes"] \
        == 9 * 3348 * 124 * 4


def _weights(cin, cout, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.standard_normal(
        (27, cin, cout)).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("cin,cout", [(3, 124), (6, 3), (64, 64),
                                      (124, 124), (124, 1024)])
def test_forward_operand_is_w_transposed(cin, cout):
    # the forward's product is xbar . W.reshape(27 * Cin, Cout): its B^T is
    # that matrix transposed, rows padded to a multiple of 8 (TMA strides)
    w = _weights(cin, cout, cin + cout)
    b = tk.product_operand(w, "fwd")
    k = 27 * cin
    assert b.shape == (cout, tk.round_up(k, 8)) and b.dtype == w.dtype
    assert b.is_contiguous() and b.stride(0) % 8 == 0
    assert torch.equal(b[:, :k], w.reshape(27 * cin, cout).T)


@pytest.mark.parametrize("cin,cout", [(124, 3), (3, 6), (64, 64),
                                      (124, 124), (1024, 124)])
def test_dx_operand_is_w_per_cell(cin, cout):
    # dX's product is Z . W^T per cell: its B^T is W laid out (Cin, 27 *
    # Cout), W[k, ci, co] at column k * Cout + co
    w = _weights(cin, cout, cin * cout)
    b = tk.product_operand(w, "dx")
    k = 27 * cout
    assert b.shape == (cin, tk.round_up(k, 8)) and b.is_contiguous()
    assert torch.equal(b[:, :k], w.permute(1, 0, 2).reshape(cin, k))
    assert torch.equal(b[:, :k],
                       w.transpose(1, 2).reshape(27 * cout, cin).T)


def test_ptxas_report():
    log = """ptxas info    : Compiling entry function '_ZN2pw17pw_product_kernelINS_10FwdProductELi128EEEv14CUtensorMap_stS2_PKfPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN2pw17pw_product_kernelINS_10FwdProductELi128EEEv14CUtensorMap_stS2_PKfPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2pw12pw_walk_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN2pw12pw_walk_kernelE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, 1024 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2pw17pw_product_kernelINS_9DxProductELi8EEEv14CUtensorMap_stS2_PKfPfiii' for 'sm_90a'
ptxas info    : (C7508) Potential Performance Loss: setmaxnreg ignored
ptxas info    : Function properties for _ZN2pw17pw_product_kernelINS_9DxProductELi8EEEv14CUtensorMap_stS2_PKfPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, 16 bytes smem, 384 bytes cmem[0]
"""
    got = tk.ptxas_kernels(log, "pw_product_kernel")
    assert [g["registers"] for g in got] == [168, 90]
    assert [g["static_smem"] for g in got] == [0, 16]
    assert all(g["spill_stores"] == g["spill_loads"] == 0 for g in got)
    assert got[0]["notes"] == [] and "setmaxnreg" in got[1]["notes"][0]
    walk = tk.ptxas_kernels(log, "pw_walk_kernel")
    assert (walk[0]["spill_stores"], walk[0]["stack"]) == (4, 8)


def test_time_products_on_the_cpu():
    recs = time_products.main(["--device", "cpu", "--shape", "fwd:128:6:5",
                               "--shape", "dx:192:3:7", "--shape",
                               "dw:192:6:5"])
    assert [(r["kind"], r["k"], r["n"]) for r in recs] == [("fwd", 162, 5),
                                                           ("dx", 189, 3),
                                                           ("dw", 162, 5)]
    for r in recs:
        assert r["ms"] == r["library_ms"] == "not measured"
        assert r["host_us"] == r["encode_us"] == "not measured"
        assert r["kernels_us"] == "not measured"
        assert r["max_rel_err"] <= time_products.MAX_REL_ERR
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0
    # dW: xbar and g (f32) read, dW (f32) written
    assert recs[2]["bytes"] == 192 * 162 * 2 + 192 * 5 * 4 + 162 * 5 * 4
    assert {s.split(":")[0] for s in time_products.DEFAULT_SHAPES} \
        == {"fwd", "dx", "dw"}
    with pytest.raises(ValueError, match="rows"):
        time_products.parse_shape("fwd:100:6:5")
    with pytest.raises(ValueError, match="rows"):
        time_products.parse_shape("dw:100:6:5")
    with pytest.raises(ValueError, match="not"):
        time_products.parse_shape("dy:128:6:5")
