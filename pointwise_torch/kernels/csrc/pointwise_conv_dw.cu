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
// splits in two steps:
//
//   the means walk   the forward's (pointwise_conv_walk.cuh, tag DwMeans),
//       dividing by the forward's counts (max(cnt, 1), f32) and rounding to
//       the matmul type into a workspace xbar (B*Ncp, 27*Cin);
//   the product      (_dw_finalize's, :434) dW = xbar^T . round(g) over all
//       B*Ncp centers: the forward's TMA / mbarrier / wgmma kernel
//       (pointwise_conv_product.cuh) under the tag DwProduct.
//
// What bounds the product on an H100: the bytes of xbar (219 MB in bf16 at
// 8 x 4096 centers and Cin = 124), read once; its 2*27*Cin*Cout flops per
// center take the tensor cores under half that time at Cout = 124.  The
// output is small (27*Cin x Cout: 14 x 1 tiles of 256 x 128 at Cin = 124,
// one at Cin = 6), so the centers split into slices to fill the SMs, and
// the slices' partial sums (S x 27*Cin x Cout f32) are written and read once
// more.  The design:
//   - A = xbar^T is M-major (the 27*Cin index is contiguous in an xbar
//     row): its tensor map runs over xbar {27*Cin, rows}, boxes of 64 rows
//     of dW (128 bytes, the 128-byte swizzle) by 64 centers, four a stage
//     for a 256-row tile; wgmma reads them with the transpose bit, a k16
//     step 16 lines further.  The map ends at 27*Cin, so the workspace's
//     garbage columns are never read, and TMA fills zeros past the last
//     center.
//   - B = round(g), written K-major by the pack kernel: gt (Cout, rows),
//     centers contiguous, so B takes the forward's K-major descriptor and
//     needs no transpose bit (the pack's transpose is one pass over g,
//     through shared memory; B is read from L2 once per 256 rows of dW).
//   - The plan (tile, stages, slices, chunk; dw_plan, mirrored by the
//     wrapper's dw_product_plan) depends on (rows, 27*Cin, Cout) only: the
//     slices aim at DW_UNITS work units, a fixed number, so dW's bits are
//     the same on any card.  The persistent grid takes min(units, SMs) CTAs:
//     no sum depends on which SM ran it.  The kernel refuses a plan other
//     than its own.
//   - pw_dw_reduce_kernel adds the slices' partial sums in ascending slice
//     order (none when one slice covers every center).
//
// Every sum runs in a fixed order and every output element has one owner:
// each slice sums its 64-center k-steps in ascending order (four k16 MMAs
// each) into a zeroed accumulator, the reduce adds the slices in order, no
// atomics.  So dW repeats bit for bit from run to run, a resumed run repeats
// a straight one, and the dense and CSR walks give identical bits (the same
// means, the same product).
//
// f32 mode (the exactness checks, off the training path): the product runs
// f32 FMAs on the CUDA cores (pw_dw_product_f32_kernel, 64 x 64 per CTA,
// the same slices), as the forward's f32 product does.
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

#include "pointwise_conv_product.cuh"

using namespace pw;

namespace {

constexpr int F_M = 64;       // rows per f32 CTA
constexpr int F_N = 64;       // columns per f32 CTA
constexpr int F_K = 32;       // centers per f32 chunk
constexpr int DW_THREADS = 256;
// Work units (tiles x slices) the plan aims at: one per SM of an H100.  A
// constant, never the card's SM count, so that the slices (and so dW's
// bits) are the same on any card.
constexpr int DW_UNITS = 132;

struct DwPlan {
  int slices;   // slices of the centers
  int kchunk;   // 64-center k-steps per slice (the last may hold fewer)
};

// The slices of a (rows x K) xbar against cout columns of g: as many as
// fit DW_UNITS / tiles (at least one, at most one per k-step), each of
// ceil(k-steps / slices) k-steps.
DwPlan dw_plan(int rows, int K, int cout) {
  const int bn = gemm_bn(cout);
  const int bm = bn <= 128 ? 256 : 128;   // GemmTile<bn>::BM
  const int tiles = ((K + bm - 1) / bm) * ((cout + bn - 1) / bn);
  const int ksteps = (rows + GEMM_BK - 1) / GEMM_BK;
  int s = DW_UNITS / tiles;
  s = s < 1 ? 1 : (s > ksteps ? ksteps : s);
  const int kchunk = (ksteps + s - 1) / s;
  return {(ksteps + kchunk - 1) / kchunk, kchunk};
}

// gt (cout, rows) bf16 = round(g)^T, g (rows, cout) f32, rows a multiple of
// 32: 32 x 32 tiles through shared memory, so that the reads of g and the
// writes of gt are both coalesced.  Block 256 threads, grid (rows / 32,
// ceil(cout / 32)).
__global__ void pw_dw_product_pack_kernel(const float* __restrict__ g,
                                          __nv_bfloat16* __restrict__ gt, int rows, int cout) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8)
    t[i][tx] = c0 + tx < cout ? g[(size_t)(r0 + i) * cout + c0 + tx] : 0.f;
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    if (c0 + i < cout) gt[(size_t)(c0 + i) * rows + r0 + tx] = __float2bfloat16_rn(t[tx][i]);
}

// f32 mode: part[s] = xbar[slice s]^T . g[slice s] with f32 FMAs in
// ascending center order; a 64 x 64 output tile per CTA, 4 x 4 per thread.
__global__ void __launch_bounds__(DW_THREADS)
pw_dw_product_f32_kernel(const float* __restrict__ xbar, int ldx,
                         const float* __restrict__ g, float* __restrict__ part,
                         int n_rows, int K, int cout, int chunk) {
  __shared__ float as[F_K][F_M];
  __shared__ float bs[F_K][F_N];
  const int o0 = blockIdx.y * F_N;
  const int k0 = blockIdx.x * F_M;
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

  for (int n0 = n_beg; n0 < n_end; n0 += F_K) {
    for (int i = threadIdx.x; i < F_K * F_M; i += DW_THREADS) {
      const int r = i / F_M, c = i % F_M;
      const int n = n0 + r;
      as[r][c] = (n < n_end && k0 + c < K) ? xbar[(size_t)n * ldx + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < F_K * F_N; i += DW_THREADS) {
      const int r = i / F_N, c = i % F_N;
      const int n = n0 + r;
      bs[r][c] = (n < n_end && o0 + c < cout) ? g[(size_t)n * cout + o0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < F_K; ++kk) {
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
  // unrolled so that the loads of eight slices are in flight at once; the
  // adds stay in ascending slice order
#pragma unroll 8
  for (int s = 1; s < S; ++s) acc += part[(size_t)s * n + i];
  dw[i] = acc;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one walk CTA (bytes); the wrapper refuses more
// than the card's 227 KB per block.
long long pw_dw_smem_bytes(int cin, int bf16) {
  return (long long)(bf16 ? walk_smem_bytes<DwMeans, __nv_bfloat16>(cin)
                          : walk_smem_bytes<DwMeans, float>(cin));
}

// bf16 elements of the walk's packed-feature scratch.
long long pw_dw_pack_elems(int cin, int bf16, int B, int Mp) {
  return (long long)(bf16 ? walk_pack_elems<__nv_bfloat16>(cin, B, Mp)
                          : walk_pack_elems<float>(cin, B, Mp));
}

// The means walk of dW: the forward's, dividing by the forward's counts
// cnt.  Ncp and Mp multiples of TILE; tile_ptr/tile_idx null = dense walk.
// feats and xbar (B*Ncp, ldx) are bf16 when bf16 != 0, else f32; packed
// holds pw_dw_pack_elems bf16.  Returns the first cudaError_t (0 =
// launched).
int pw_conv_dw_means(const void* ctr, const void* pts, const void* feats, void* packed,
                     const void* tile_ptr, const void* tile_idx, const void* cnt, void* xbar,
                     int ldx, int B, int Ncp, int Mp, int cin, float radius, float inv,
                     int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch_walk<DwMeans, T>(
        static_cast<const float*>(ctr), static_cast<const float*>(pts), feats,
        static_cast<__nv_bfloat16*>(packed), nullptr, static_cast<const int*>(tile_ptr),
        static_cast<const int*>(tile_idx), static_cast<const float*>(cnt), nullptr,
        static_cast<T*>(xbar), ldx, B, Ncp, Mp, cin, radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

// dW (K, cout) f32 = xbar^T . round(g) over n_rows centers (a multiple of
// 64), K = 27*cin columns of xbar (n_rows, ldx) read.  bf16 != 0: xbar bf16
// at a 16-byte aligned address, ldx a multiple of 8, gt scratch of
// cout*n_rows bf16; bn, bm, stages the tile of product_plan's rule and grid
// the persistent grid (1 <= grid <= tiles * slices).  Else xbar f32, gt
// and the tile unused.  Both: slices and chunk (centers, a multiple of 64)
// must be dw_plan's; part holds slices*K*cout f32 (unused when slices ==
// 1).  Returns the first cudaError_t of the launches (0 = launched), or
// minus the CUresult of a failed tensor-map encode.
int pw_conv_dw_product(const void* xbar, int ldx, const void* g, void* gt, void* part,
                       void* dw, int n_rows, int K, int cout, int bf16, int bn, int bm,
                       int stages, int slices, int chunk, int grid, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const DwPlan plan = dw_plan(n_rows, K, cout);
  if (n_rows % TILE != 0 || slices != plan.slices || chunk != plan.kchunk * GEMM_BK)
    return (int)cudaErrorInvalidValue;
  float* out = slices == 1 ? static_cast<float*>(dw) : static_cast<float*>(part);
  int err;
  if (bf16) {
    pw_dw_product_pack_kernel<<<dim3(n_rows / 32, (cout + 31) / 32), 256, 0, st>>>(
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(gt), n_rows, cout);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    // the product's rows are dW's (K), its reduction the centers
    err = dispatch_gemm<DwProduct>(xbar, ldx, gt, n_rows, nullptr, out, K, n_rows, cout,
                                   plan.kchunk, bn, bm, stages, grid, st);
  } else {
    dim3 fgrid((K + F_M - 1) / F_M, (cout + F_N - 1) / F_N, slices);
    pw_dw_product_f32_kernel<<<fgrid, DW_THREADS, 0, st>>>(
        static_cast<const float*>(xbar), ldx, static_cast<const float*>(g), out, n_rows, K,
        cout, chunk);
    err = (int)cudaGetLastError();
  }
  if (err != 0 || slices == 1) return err;
  const int n = K * cout;
  pw_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                       static_cast<float*>(dw), n, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
