// pointwise_conv_fwd.cu — forward pointwise convolution for Hopper (sm_90a).
//
// Replaces the three forward Pallas kernels of
// pointwise_tpu/kernels/pointwise_conv_pallas.py:
//   _fwd_kernel_resident (:320)  dense walk, candidate block resident in VMEM
//   _fwd_kernel          (:268)  dense walk over a (B, Nc/tn, Mp/tm) grid
//   _fwd_kernel_csr      (:599)  walk over the bbox-adjacent candidate tiles
// with ONE kernel that walks a per-center-tile list of candidate tiles:
// the dense modes walk every tile (tile_idx == nullptr), the CSR mode walks
// tile_idx[tile_ptr[b * n_rows + row] : tile_ptr[b * n_rows + row + 1]], a
// compact list (offsets plus indices).  The list has no length cap, so the
// TPU's degree-overflow fallback and SMEM chunking have nothing to protect
// here.  The finalize (_finalize_tile :297: mean per cell, then
// the (27*Cin) x Cout product plus bias) runs in the same kernel.
//
// Design.  A block owns CPB = 8 consecutive centers, one warp each.  For
// every listed candidate tile (TILE = 64 points) the block stages the
// coordinates and feature rows in shared memory; each warp's lanes test 32
// candidates at a time against its center, ballot the in-ball ones, and for
// each of them (in ascending candidate order) add its feature row into the
// center's [27][Cin] f32 cell sums in shared memory, lane c owning channels
// c, c+32, ...  Every output row is owned by one block and every sum is
// taken in a fixed order: no atomics, so results repeat bit for bit from
// run to run, and the dense and CSR walks give identical bits (the CSR list
// only drops tiles that hold no in-ball candidate).  The finalize divides
// by max(count, 1) in f32 (rounding the means to bf16 in bf16 mode), then
// 256 threads form the product: thread t owns output column t % 128 for
// all 8 centers over one half of the 27*Cin reduction; the two halves add
// in a fixed order, then the bias.
//
// What bounds it on an H100.  The cell sums: every in-ball pair costs Cin
// f32 adds on the CUDA cores (67 TFLOP/s, the operations bound that
// chip_smoke.py reports), and at the serving shapes (thousands of
// neighbors per center at r = 0.8) they dominate.  Measured, the kernel is
// far above that bound: each pair costs a ballot/shuffle step plus Cin/32
// shared-memory read-modify-writes per lane, and the 140 KB of shared
// memory per block (f32 sums for 8 centers) leave one block, 8 warps, per
// SM, so the loop is bound by issue and latency (PERF.md).  The product
// reads W (27*Cin*Cout) from L2 once per block of 8 centers.  Tensor cores
// (wgmma) for the product, more warps per SM and a cell-sorted
// aggregation are later work.
//
// The cell code, the walk and the product are shared with the dW and dX
// kernels (pointwise_conv_common.cuh, which states the exactness rules).
//
// bf16 mode (feats and w in bf16): features are already rounded, cell sums
// and counts stay f32, the means are divided in f32 and then rounded to
// bf16, the product accumulates in f32 and the bias is added in f32.
//
// The C entry point checks the launch with cudaGetLastError and returns the
// code; the Python wrapper raises on anything but 0.

#include "pointwise_conv_common.cuh"

namespace {

using namespace pw;

template <typename T>
__global__ void __launch_bounds__(THREADS)
pw_fwd_kernel(const float* __restrict__ ctr,   // (B, Ncp, 3)
              const float* __restrict__ pts,   // (B, Mp, 3)
              const T* __restrict__ feats,     // (B, Mp, cin)
              const T* __restrict__ w,         // (27, cin, cout)
              const float* __restrict__ bias,  // (cout,)
              const int* __restrict__ tile_ptr,  // (B * Ncp/TILE + 1) or null
              const int* __restrict__ tile_idx,  // (tile_ptr[-1],) or null
              float* __restrict__ y,           // (B, Ncp, cout)
              float* __restrict__ cnt_out,     // (B, Ncp, 27)
              int Ncp, int Mp, int cin, int cout, float radius, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int K = N_CELLS * cin;
  float* sums = smem;                    // CPB * K
  float* cnts = sums + CPB * K;          // CPB * 27
  float* part = cnts + CPB * N_CELLS;    // CPB * HALF (product halves)
  float* cxyz = part + CPB * HALF;       // TILE * 3
  T* cf = reinterpret_cast<T*>(cxyz + TILE * 3);   // TILE * cin

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  cell_sums<T>(ctr, pts, feats, tile_ptr, tile_idx, b, c0, Ncp, Mp, cin, radius, inv,
               sums, cnts, cxyz, cf);

  // means per cell (rounded to the matmul type), counts out
  for (int i = threadIdx.x; i < CPB * K; i += THREADS) {
    const int cc = i / K;
    const int k = (i - cc * K) / cin;
    sums[i] = round_like<T>(sums[i] / fmaxf(cnts[cc * N_CELLS + k], 1.f));
  }
  for (int i = threadIdx.x; i < CPB * N_CELLS; i += THREADS)
    cnt_out[((size_t)b * Ncp + c0) * N_CELLS + i] = cnts[i];
  __syncthreads();

  block_product<T>(sums, w, bias, y + ((size_t)b * Ncp + c0) * cout, cout, K, cout,
                   part);
}

template <typename T>
size_t smem_bytes(int cin) {
  return sizeof(float) * ((size_t)CPB * (N_CELLS * cin + N_CELLS + HALF) + TILE * 3)
         + sizeof(T) * (size_t)TILE * cin;
}

template <typename T>
int launch(const float* ctr, const float* pts, const void* feats, const void* w,
           const float* bias, const int* tile_ptr, const int* tile_idx, float* y,
           float* cnt, int B, int Ncp, int Mp, int cin, int cout, float radius, float inv,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(cin);
  cudaError_t err = cudaFuncSetAttribute(
      pw_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Ncp / CPB, B);
  pw_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      ctr, pts, static_cast<const T*>(feats), static_cast<const T*>(w), bias,
      tile_ptr, tile_idx, y, cnt, Ncp, Mp, cin, cout, radius, inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The candidate tile, read by the Python wrapper to check its own copy.
int pw_conv_tile() { return TILE; }

// Dynamic shared memory one block needs (bytes); the wrapper refuses
// widths above the card's 227 KB per block.
long long pw_conv_smem_bytes(int cin, int bf16) {
  return (long long)(bf16 ? smem_bytes<__nv_bfloat16>(cin) : smem_bytes<float>(cin));
}

// Forward conv.  Ncp and Mp must be multiples of TILE.  tile_ptr/tile_idx
// null = dense walk.  feats and w are bf16 when bf16 != 0, else f32.  Returns the
// cudaError_t of the launch (0 = launched).
int pw_conv_fwd(const void* ctr, const void* pts, const void* feats, const void* w,
                const void* bias, const void* tile_ptr, const void* tile_idx, void* y,
                void* cnt, int B, int Ncp, int Mp, int cin, int cout, float radius,
                float inv, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(static_cast<const float*>(ctr), static_cast<const float*>(pts),
                     feats, w, static_cast<const float*>(bias),
                     static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
                     static_cast<float*>(y), static_cast<float*>(cnt), B, Ncp, Mp,
                     cin, cout, radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

}  // extern "C"
