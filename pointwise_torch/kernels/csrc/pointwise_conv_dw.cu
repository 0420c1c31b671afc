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
//   pw_dw_product_kernel (_dw_finalize's product, :434) dW = xbar^T .
//       round(g) over all B*Ncp centers, on tensor cores: g is rounded to
//       bf16 once per call (pw_dw_product_pack_kernel, rows padded to a
//       multiple of 8 columns); a CTA owns 128 rows of dW (its 27*Cin
//       index) x 128 columns (Cout), 8 warps of 32 x 64, and streams xbar
//       and round(g) through shared memory in k-steps of 32 centers,
//       double-buffered with cp.async.  xbar^T's A fragments come from the
//       row-major xbar tile by ldmatrix.trans, round(g)'s B fragments by
//       ldmatrix.trans as in the forward's product, into mma.sync.m16n8k16
//       (bf16 in, f32 accumulate).  The centers split into S slices of
//       `chunk` centers (S from the wrapper, so that enough CTAs fill the
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
// (the walk header's note).  The product reads the xbar workspace (219 MB
// in bf16 at 8 x 4096 centers, Cin = 124) once, since one CTA column holds
// all of Cout up to 128, and round(g) once per 128 rows of dW (from L2);
// its 2*27*Cin*Cout flops per center take the tensor cores a fraction of
// that time, so it is bound by bytes.  The partial sums (S x 27*Cin x Cout
// f32) are written and read once more by the reduce.  Fusing the product
// into the walk with a cluster-level reduction is later work.
//
// f32 mode (the exactness checks, off the training path): the product runs
// f32 FMAs on the CUDA cores (pw_dw_product_f32_kernel, 64 x 64 per CTA),
// as the forward's f32 product does.
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

using namespace pw;

namespace {

constexpr int DW_M = 128;     // rows of dW (27*Cin index) per tensor-core CTA
constexpr int DW_N = 128;     // columns of dW (Cout) per tensor-core CTA
constexpr int DW_K = 32;      // centers per staged k-step
constexpr int F_M = 64;       // rows per f32 CTA
constexpr int F_N = 64;       // columns per f32 CTA
constexpr int F_K = 32;       // centers per f32 chunk
constexpr int DW_THREADS = 256;

// gb (n_rows, ldg) bf16 = round(g), zero past cout.
__global__ void pw_dw_product_pack_kernel(const float* __restrict__ g,
                                          __nv_bfloat16* __restrict__ gb, int n_rows,
                                          int cout, int ldg) {
  const size_t n = (size_t)n_rows * ldg;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % ldg);
    const size_t r = i / ldg;
    gb[i] = __float2bfloat16_rn(c < cout ? g[r * cout + c] : 0.f);
  }
}

// part[s] = xbar[slice s]^T . gb[slice s] (bf16 in, f32 accumulate).  xbar
// (n_rows, ldx) with K columns read, gb (n_rows, ldg); grid (ceil(K /
// DW_M), ceil(cout / DW_N), S); slice s holds centers s*chunk .. +chunk
// (a multiple of DW_K, as is n_rows).
__global__ void __launch_bounds__(DW_THREADS, 2)
pw_dw_product_kernel(const __nv_bfloat16* __restrict__ xbar, int ldx,
                     const __nv_bfloat16* __restrict__ gb, int ldg,
                     float* __restrict__ part, int n_rows, int K, int cout, int chunk) {
  __shared__ __align__(16) __nv_bfloat16 as[2][DW_K][DW_M + 8];   // xbar rows
  __shared__ __align__(16) __nv_bfloat16 bs[2][DW_K][DW_N + 8];   // gb rows
  const int k0 = blockIdx.x * DW_M;
  const int o0 = blockIdx.y * DW_N;
  const int s = blockIdx.z;
  const int n_beg = s * chunk;
  const int n_end = min(n_beg + chunk, n_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;   // rows wm*32.., columns wn*64..

  auto stage = [&](int n0, int buf) {
    for (int c = threadIdx.x; c < DW_K * DW_M / 8; c += DW_THREADS) {   // A
      const int r = c >> 4, q = c & 15;
      const int k = k0 + q * 8;
      const int valid = K - k >= 8 ? 8 : (K - k > 0 ? K - k : 0);
      cp_async16(&as[buf][r][q * 8], xbar + (size_t)(n0 + r) * ldx + (valid > 0 ? k : 0),
                 valid * 2);
    }
    for (int c = threadIdx.x; c < DW_K * DW_N / 8; c += DW_THREADS) {   // B
      const int r = c >> 4, q = c & 15;
      const int o = o0 + q * 8;
      const bool ok = o < ldg;
      cp_async16(&bs[buf][r][q * 8], ok ? gb + (size_t)(n0 + r) * ldg + o : gb, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix.trans row addresses of the A fragments: lane l reads center
  // row (l & 7) + ((l >> 4) << 3) of the k16 step, dW rows from column
  // ((l >> 3) & 1) * 8 of the m16 tile
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = ((lane >> 3) & 1) * 8;
  const int nk = (n_end - n_beg) / DW_K;
  if (nk > 0) stage(n_beg, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();   // step kt landed; step kt-1 consumed
    if (kt + 1 < nk) stage(n_beg + (kt + 1) * DW_K, buf ^ 1);
#pragma unroll
    for (int ks = 0; ks < DW_K / 16; ++ks) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(af[mi], &as[buf][ks * 16 + a_row][wm * 32 + mi * 16 + a_col]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned bb[4];
        ldsm_x4_t(bb, &bs[buf][ks * 16 + (lane & 15)][wn * 64 + p * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * p], af[mi], bb[0], bb[1]);
          mma_bf16(acc[mi][2 * p + 1], af[mi], bb[2], bb[3]);
        }
      }
    }
  }

  float* pb = part + (size_t)s * K * cout;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wm * 32 + mi * 16 + g + 8 * h;
      if (k >= K) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o0 + wn * 64 + j * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (o + e < cout) pb[(size_t)k * cout + o + e] = acc[mi][j][2 * h + e];
      }
    }
  }
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
// 32), K = 27*cin columns of xbar (n_rows, ldx) read.  bf16 != 0: xbar
// bf16, ldx a multiple of 8, gb scratch of n_rows*ldg bf16 (ldg = cout
// rounded up to 8); else xbar f32 and gb unused.  The centers split into
// `splits` slices of `chunk` (a multiple of 32); part holds
// splits*K*cout f32 (unused when splits == 1).  Returns the first
// cudaError_t of the launches (0 = launched).
int pw_conv_dw_product(const void* xbar, int ldx, const void* g, void* gb, int ldg, void* part,
                       void* dw, int n_rows, int K, int cout, int splits, int chunk, int bf16,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  float* out = splits == 1 ? static_cast<float*>(dw) : static_cast<float*>(part);
  if (bf16) {
    const size_t n = (size_t)n_rows * ldg;
    pw_dw_product_pack_kernel<<<grid_blocks(n), 256, 0, st>>>(
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(gb), n_rows, cout, ldg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((K + DW_M - 1) / DW_M, (cout + DW_N - 1) / DW_N, splits);
    pw_dw_product_kernel<<<grid, DW_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xbar), ldx, static_cast<const __nv_bfloat16*>(gb),
        ldg, out, n_rows, K, cout, chunk);
  } else {
    dim3 grid((K + F_M - 1) / F_M, (cout + F_N - 1) / F_N, splits);
    pw_dw_product_f32_kernel<<<grid, DW_THREADS, 0, st>>>(
        static_cast<const float*>(xbar), ldx, static_cast<const float*>(g), out, n_rows, K,
        cout, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = K * cout;
  pw_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                       static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
