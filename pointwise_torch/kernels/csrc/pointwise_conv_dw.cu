// pointwise_conv_dw.cu — weight gradient of the pointwise convolution for
// Hopper (sm_90a).
//
// Replaces the dW Pallas kernels of
// pointwise_tpu/kernels/pointwise_conv_pallas.py:
//   _dw_kernel_resident (:396) + _dw_finalize (:434)  dense walk in values
//   _dw_kernel          (:842)  dense walk over a (B, Nc/tn, Mp/tm) grid
//   _dw_kernel_csr      (:636)  walk over the bbox-adjacent candidate tiles
// which all compute dW_k = sum over centers of bf16(xbar_k)^T . bf16(g), the
// cell means xbar recomputed by the forward's walk.  On the TPU the
// (27, Cinp, Coutp) output block stays resident in VMEM while the grid runs
// its center tiles in order; on the GPU blocks run in no order, so the work
// splits in two kernels:
//
//   the means walk       the forward's (pointwise_conv_walk.cuh): 16
//       centers per CTA walk every candidate tile or the CSR list and sum
//       each cell's features on tensor cores (0/1 cell planes x features,
//       mma.sync, empty cells skipped per 16 x 16 block); the sums are
//       divided by the forward's counts (max(cnt, 1), f32) and rounded to
//       the matmul type into a workspace xbar (B*Ncp, 27*Cin);
//   pw_dw_product_kernel dW = xbar^T . round(g) over all B*Ncp centers: a
//       64 x 64 output tile per block, 4 x 4 per thread, centers in chunks
//       of 32 staged in shared memory.  The centers split into S slices of
//       `chunk` centers (S from the wrapper, so that enough blocks fill the
//       card); each slice writes its partial sums to a workspace and
//       pw_dw_reduce_kernel adds the S partials in ascending slice order.
//
// Every sum runs in a fixed order and every output element has one owner:
// no atomics, so dW repeats bit for bit from run to run, and the dense and
// CSR walks give identical bits (the same means, the same product).
//
// What bounds it on an H100.  The means walk costs what the forward's walk
// costs: one pair_code per listed entry and walk CTA and the per-cell
// tests on the CUDA cores, the populated cells' MMAs on the tensor cores
// (the walk header's note).  The product is 2*27*Cin*Cout flops per center
// on the CUDA cores (f32 FMAs of bf16-exact operands), ~2.5% of a training
// step; it reads the xbar workspace (219 MB in bf16 at 8 x 4096 centers,
// Cin = 124) once per column tile of 64 outputs.  Tensor cores for the
// product, and fusing it into the walk with a cluster-level reduction, are
// later work.
//
// Why the walk runs again instead of taking the forward's xbar.  The
// forward writes the same bits, but the autograd function keeps only the
// op's inputs and counts between forward and backward.  Keeping xbar would
// hold one workspace per conv from the forward to its backward: 219 MB in
// bf16 per conv at 8 x 4096 centers and Cin = 124, ~0.9 GB for the four
// convs of a segmentation step.  That memory would buy back one walk per
// conv (the dW walk's share of a step is in PERF.md); taking it is later
// work, together with a change of the autograd function.
//
// Rounding (the TPU op's _pw_bwd :1295-1308): g arrives in f32 and is
// rounded to the matmul type before the product; xbar is rounded as in the
// forward; products accumulate in f32 and dW is f32 (the gradient of the
// f32 weights, which the forward casts).
//
// The C entry point checks each launch with cudaGetLastError and returns the
// first error code; the Python wrapper raises on anything but 0.

#include "pointwise_conv_walk.cuh"

namespace {

using namespace pw;

constexpr int PM = 64;     // output rows (27*Cin index) per product block
constexpr int PN = 64;     // output columns (Cout) per product block
constexpr int PK = 32;     // centers per staged chunk
constexpr int PTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PTHREADS)
pw_dw_product_kernel(const T* __restrict__ xbar,    // (n_rows, K)
                     const float* __restrict__ g,   // (n_rows, cout)
                     float* __restrict__ part,      // (S, K, cout)
                     int n_rows, int K, int cout, int chunk) {
  __shared__ float as[PK][PM];
  __shared__ float bs[PK][PN];
  const int o0 = blockIdx.x * PN;
  const int k0 = blockIdx.y * PM;
  const int s = blockIdx.z;
  const int n_beg = s * chunk;
  const int n_end = min(n_beg + chunk, n_rows);
  const int tx = threadIdx.x % 16;    // columns o0 + tx*4 .. +3
  const int ty = threadIdx.x / 16;    // rows k0 + ty*4 .. +3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = n_beg; n0 < n_end; n0 += PK) {
    for (int i = threadIdx.x; i < PK * PM; i += PTHREADS) {
      const int r = i / PM, c = i % PM;
      const int n = n0 + r;
      as[r][c] = (n < n_end && k0 + c < K) ? to_f32(xbar[(size_t)n * K + k0 + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < PK * PN; i += PTHREADS) {
      const int r = i / PN, c = i % PN;
      const int n = n0 + r;
      bs[r][c] = (n < n_end && o0 + c < cout)
                     ? round_like<T>(g[(size_t)n * cout + o0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < PK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* pb = part + (size_t)s * K * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < cout) pb[(size_t)k * cout + o] = acc[i][j];
    }
  }
}

__global__ void pw_dw_reduce_kernel(const float* __restrict__ part,  // (S, n)
                                    float* __restrict__ dw, int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int s = 1; s < S; ++s) acc += part[(size_t)s * n + i];
  dw[i] = acc;
}

template <typename T>
int launch(const float* ctr, const float* pts, const void* feats, const float* g,
           const float* cnt, const int* tile_ptr, const int* tile_idx, void* packed,
           void* xbar, float* part, float* dw, int B, int Ncp, int Mp, int cin, int cout,
           int splits, int chunk, float radius, float inv, cudaStream_t stream) {
  int code = launch_walk<DwMeans, T>(ctr, pts, static_cast<const T*>(feats),
                            static_cast<__nv_bfloat16*>(packed), tile_ptr, tile_idx, cnt,
                            nullptr, static_cast<T*>(xbar), N_CELLS * cin, B, Ncp, Mp, cin,
                            radius, inv, stream);
  if (code != 0) return code;
  cudaError_t err;

  const int K = N_CELLS * cin;
  const int n_rows = B * Ncp;
  float* out = splits == 1 ? dw : part;
  dim3 grid((cout + PN - 1) / PN, (K + PM - 1) / PM, splits);
  pw_dw_product_kernel<T><<<grid, PTHREADS, 0, stream>>>(
      static_cast<const T*>(xbar), g, out, n_rows, K, cout, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;

  const int n = K * cout;
  pw_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one walk CTA (bytes); the wrapper refuses more
// than the card's 227 KB per block.
long long pw_dw_smem_bytes(int cin, int bf16) {
  return (long long)(bf16 ? walk_smem_bytes<__nv_bfloat16>(cin) : walk_smem_bytes<float>(cin));
}

// bf16 elements of the walk's packed-feature scratch.
long long pw_dw_pack_elems(int cin, int bf16, int B, int Mp) {
  return (long long)(bf16 ? walk_pack_elems<__nv_bfloat16>(cin, B, Mp)
                          : walk_pack_elems<float>(cin, B, Mp));
}

// Weight gradient.  Ncp and Mp must be multiples of TILE; tile_ptr/tile_idx
// null = dense walk.  feats (and the xbar workspace, B*Ncp*27*cin) are bf16
// when bf16 != 0, else f32; packed holds pw_dw_pack_elems bf16 of scratch;
// g, cnt and dw (27*cin*cout) are f32.  The
// centers split into `splits` slices of `chunk`; part holds
// splits*27*cin*cout f32 (unused when splits == 1).  Returns the first
// cudaError_t of the launches (0 = launched).
int pw_conv_dw(const void* ctr, const void* pts, const void* feats, const void* g,
               const void* cnt, const void* tile_ptr, const void* tile_idx, void* packed,
               void* xbar,
               void* part, void* dw, int B, int Ncp, int Mp, int cin, int cout,
               int splits, int chunk, float radius, float inv, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(static_cast<const float*>(ctr), static_cast<const float*>(pts),
                     feats, static_cast<const float*>(g),
                     static_cast<const float*>(cnt), static_cast<const int*>(tile_ptr),
                     static_cast<const int*>(tile_idx), packed, xbar,
                     static_cast<float*>(part),
                     static_cast<float*>(dw), B, Ncp, Mp, cin, cout, splits, chunk,
                     radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

}  // extern "C"
