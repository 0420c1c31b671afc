// pointwise_conv_fwd.cu — forward pointwise convolution for Hopper (sm_90a).
//
// Replaces the three forward Pallas kernels of
// pointwise_tpu/kernels/pointwise_conv_pallas.py:
//   _fwd_kernel_resident (:320)  dense walk, candidate block resident in VMEM
//   _fwd_kernel          (:268)  dense walk over a (B, Nc/tn, Mp/tm) grid
//   _fwd_kernel_csr      (:599)  walk over the bbox-adjacent candidate tiles
// with two kernels, run back to back by the wrapper:
//
//   the means walk (pointwise_conv_walk.cuh, shared with dW) walks, for
//       each row tile of centers, every candidate tile (tile_idx ==
//       nullptr) or tile_idx[tile_ptr[b*n_rows + row] : ...+1], a compact
//       list (offsets plus indices) with no length cap, so the TPU's
//       degree-overflow fallback and SMEM chunking have nothing to protect
//       here.  It sums each cell's features on tensor cores (0/1 cell planes
//       x features, mma.sync, empty cells skipped per 16 x 16 block), writes
//       the walk's counts to cnt and the means, divided in f32 by
//       max(count, 1) and rounded to the matmul type, to a workspace xbar
//       (B*Ncp rows, row stride ldx >= 27*Cin, a multiple of 8);
//   the product (pointwise_conv_product.cuh, shared with dX),
//       _finalize_tile's product (:297): y = xbar . W + bias, (rows x
//       27*Cin) x (27*Cin x Cout), on tensor cores (TMA into an mbarrier
//       ring, wgmma, a persistent grid; 256 centers x 128 outputs per tile
//       at Cout 124), the bias added in f32 after the sum.  W is read from
//       L2 once per tile.
//
// Every output row is owned by one thread per column and every sum runs in
// a fixed order: no atomics, so results repeat bit for bit from run to run,
// and the dense and CSR walks give identical bits.
//
// What bounds it on an H100.  The walk takes ~97% of the forward: latency,
// at 2 CTAs per SM (their accumulators fill the register file), through
// the codes (one pair_code per candidate of the k-steps the CTA's cull
// keeps), the per-cell tests, two barriers per iteration and the means'
// stores (the walk header's note).  The product:
// the xbar workspace (27*Cin bf16 per center) read once from device memory
// and 2*27*Cin*Cout flops per center at the tensor cores' rate.  Sharing
// the codes across a center tile's CTAs (a cluster) and fusing the product
// into the walk are later work.
//
// External counts (replaces the ext-counts variants of the same three
// kernels, pointwise_conv_pallas_ext :1366-1403, the cnt_in argument of
// _fwd_call_resident :366, _fwd_call :1075 and _fwd_call_csr :1028): with a
// non-null cnt_in (B, Ncp, 27) the means divide by max(cnt_in, 1) instead of
// the walk's own counts, with the same rounding and product.  cnt still
// receives the walk's own counts.  The ring strategy passes the counts over
// every candidate of the space group, so the outputs of disjoint candidate
// slabs sum to the convolution over all of them; a center with positive
// cnt_in but no neighbor in the slab gets zero sums, so its output is
// exactly the bias (which the op layer keeps at zero there).
//
// bf16 mode (feats and w in bf16): features are already rounded, cell sums
// and counts stay f32, the means are divided in f32 and then rounded to
// bf16, the product accumulates in f32 and the bias is added in f32.
// f32 mode: the walk splits the features in three bf16 terms (exact, see
// the walk header); the product runs f32 FMAs on the CUDA cores
// (pw_product_f32_kernel).  f32 mode is off the serving and training
// paths (they run bf16) and serves the exactness checks, where f32
// operands on tensor cores would need six bf16 MMAs per product.
//
// The C entry points check each launch with cudaGetLastError and return the
// first error code; the Python wrapper raises on anything but 0.

#include "pointwise_conv_product.cuh"

using namespace pw;

extern "C" {

// The candidate tile, read by the Python wrapper to check its own copy.
int pw_conv_tile() { return TILE; }

// The widest Cin (forward, dW) and Cout (forward, dX) the kernels take.
int pw_conv_max_width() { return MAX_WIDTH; }

// Dynamic shared memory of one walk CTA (bytes); the wrapper refuses more
// than the card's 227 KB per block.
long long pw_conv_smem_bytes(int cin, int bf16) {
  return (long long)(bf16 ? walk_smem_bytes<FwdMeans, __nv_bfloat16>(cin)
                          : walk_smem_bytes<FwdMeans, float>(cin));
}

// bf16 elements of the walk's packed-feature scratch.
long long pw_conv_pack_elems(int cin, int bf16, int B, int Mp) {
  return (long long)(bf16 ? walk_pack_elems<__nv_bfloat16>(cin, B, Mp)
                          : walk_pack_elems<float>(cin, B, Mp));
}

// The means walk.  Ncp and Mp multiples of TILE; tile_ptr/tile_idx null =
// dense walk; cnt_in null = divide by the walk's own counts, which go to
// cnt.  feats and xbar (B*Ncp, ldx) are bf16 when bf16 != 0, else f32;
// packed holds pw_conv_pack_elems bf16.  Returns the first cudaError_t (0 =
// launched).
int pw_conv_fwd_means(const void* ctr, const void* pts, const void* feats, void* packed,
                      const void* tile_ptr, const void* tile_idx, const void* cnt_in,
                      void* cnt, void* xbar, int ldx, int B, int Ncp, int Mp, int cin,
                      float radius, float inv, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch_walk<FwdMeans, T>(static_cast<const float*>(ctr), static_cast<const float*>(pts),
                          feats, static_cast<__nv_bfloat16*>(packed), nullptr,
                          static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
                          static_cast<const float*>(cnt_in), static_cast<float*>(cnt),
                          static_cast<T*>(xbar), ldx, B, Ncp, Mp, cin, radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

// y (rows, cout) f32 = xbar (rows, ldx; K = 27*cin columns read) . w + bias.
// rows a multiple of 64.  bf16 != 0: xbar bf16 at a 16-byte aligned
// address, ldx a multiple of 8; w = W^T (cout, ldw) bf16, ldw a multiple of
// 8; bn, bm, stages and grid the wrapper's plan (launch_product).  Else
// f32, w (K, cout).  Returns the cudaError_t of the launch (0 = launched),
// or minus the CUresult of a failed tensor-map encode.
int pw_conv_fwd_product(const void* xbar, int ldx, const void* w, int ldw,
                        const void* bias, void* y, int rows, int K, int cout, int bf16,
                        int bn, int bm, int stages, int grid, void* stream) {
  return launch_product<FwdProduct>(xbar, ldx, w, ldw, static_cast<const float*>(bias),
                                    static_cast<float*>(y), rows, K, cout, bf16, bn, bm,
                                    stages, grid, static_cast<cudaStream_t>(stream));
}

// The two tensor maps of a bf16 product alone, encoded on the host and
// dropped (mn != 0: dW's M-major A): the host's share of a product launch,
// timed by pointwise_torch/tools/time_products.py.  Returns 0, or minus the
// CUresult of a failed encode.
int pw_product_encode(const void* a, int lda, const void* wt, int ldw, int rows, int K, int n,
                      int mn) {
  CUtensorMap ta, tb;
  return encode_product_maps(&ta, &tb, mn != 0, a, lda, wt, ldw, rows, K, n);
}

}  // extern "C"
