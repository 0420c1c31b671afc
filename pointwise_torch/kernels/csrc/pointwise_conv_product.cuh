// pointwise_conv_product.cuh — the (rows x K) x (K x N) product that the
// forward (pointwise_conv_fwd.cu) and the feature gradient
// (pointwise_conv_dx.cu) end with: _finalize_tile's product (:297) and
// _dx_finalize's (:476) of pointwise_tpu/kernels/pointwise_conv_pallas.py.
//
//   forward  y  = xbar . W + bias,    xbar (rows, 27*Cin),  W (27*Cin, Cout)
//   dX       dx = round(Z) . W^T,     Z (rows, 27*Cout),    W^T (27*Cout, Cin)
//
// bf16 (pw_product_kernel): a CTA owns 64 rows x 128 columns, 8 warps of 16
// x 64, and streams A and B through shared memory in k-steps of 32,
// double-buffered with cp.async; ldmatrix feeds mma.sync.m16n8k16 (bf16
// in, f32 accumulate), and the bias, where there is one, is added in f32
// after the sum.  B is read from L2 once per 64 rows.  f32 (the exactness
// checks, off the serving and training paths): pw_product_f32_kernel, f32
// FMAs on the CUDA cores in ascending k, a 64 x 64 output tile per CTA.
//
// Every output element has one owner thread and one summation order: the
// result repeats bit for bit.  The tag (FwdProduct, DxProduct) names the
// kernel, so traces tell the forward's product from dX's.
//
// What bounds it on an H100: the A operand (27*Cin or 27*Cout bf16 per row)
// read once from device memory; its 2*K*N flops per row run on the tensor
// cores well under that time.

#pragma once

#include "pointwise_conv_walk.cuh"

namespace pw {

struct FwdProduct {};
struct DxProduct {};

constexpr int PROD_M = 64;      // rows per product CTA
constexpr int PROD_N = 128;     // columns per product CTA
constexpr int PROD_K = 32;      // k-step of the staged tiles
constexpr int PROD_THREADS = 256;
constexpr int PROD_F32_N = 64;  // columns per f32 product CTA

// y = a . w (+ bias), bf16 operands, f32 accumulate.  a (rows, lda),
// columns >= K never read; w (K, ldw), ldw a multiple of 8 (zero columns
// past n); bias (n,) f32 or null; grid (rows / PROD_M, ceil(n / PROD_N)).
template <typename Tag>
__global__ void __launch_bounds__(PROD_THREADS)
pw_product_kernel(const __nv_bfloat16* __restrict__ a, int lda,
                  const __nv_bfloat16* __restrict__ w, int ldw,
                  const float* __restrict__ bias, float* __restrict__ y, int K, int n) {
  __shared__ __align__(16) __nv_bfloat16 as[2][PROD_M][PROD_K + 8];
  __shared__ __align__(16) __nv_bfloat16 bs[2][PROD_K][PROD_N + 8];
  const int r0 = blockIdx.x * PROD_M;
  const int o0 = blockIdx.y * PROD_N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;   // rows wm*16.., columns wn*64..

  auto stage = [&](int kt, int buf) {
    const int k0 = kt * PROD_K;
    {   // A: 64 rows x 4 chunks of 8
      const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
      const int k = k0 + q * 8;
      const int valid = K - k >= 8 ? 8 : (K - k > 0 ? K - k : 0);
      const __nv_bfloat16* src = a + (size_t)(r0 + r) * lda + (valid > 0 ? k : 0);
      cp_async16(&as[buf][r][q * 8], src, valid * 2);
    }
    for (int c = threadIdx.x; c < PROD_K * PROD_N / 8; c += PROD_THREADS) {   // B
      const int rr = c >> 4, q = c & 15;
      const int k = k0 + rr, o = o0 + q * 8;
      const bool ok = k < K && o < ldw;
      cp_async16(&bs[buf][rr][q * 8], ok ? w + (size_t)k * ldw + o : w, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = (K + PROD_K - 1) / PROD_K;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();   // step kt landed; step kt-1 consumed
    if (kt + 1 < nk) stage(kt + 1, buf ^ 1);
#pragma unroll
    for (int ks = 0; ks < PROD_K / 16; ++ks) {
      unsigned af[4];
      ldsm_x4(af, &as[buf][wm * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned bb[4];
        ldsm_x4_t(bb, &bs[buf][ks * 16 + (lane & 15)][wn * 64 + p * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * p], af, bb[0], bb[1]);
        mma_bf16(acc[2 * p + 1], af, bb[2], bb[3]);
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = o0 + wn * 64 + j * 8 + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* yr = y + (size_t)(r0 + wm * 16 + g + 8 * h) * n;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (o + e < n)
          yr[o + e] = bias != nullptr ? acc[j][2 * h + e] + bias[o + e] : acc[j][2 * h + e];
    }
  }
}

// f32 mode: y = a . w (+ bias) with f32 FMAs in ascending k; a 64 x 64
// output tile per CTA, 4 x 4 per thread.  w (K, n).
template <typename Tag>
__global__ void __launch_bounds__(PROD_THREADS)
pw_product_f32_kernel(const float* __restrict__ a, int lda, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y, int K, int n) {
  __shared__ float as[PROD_K][PROD_M + 1];   // +1: the transposing stores spread over banks
  __shared__ float bs[PROD_K][PROD_F32_N];
  const int r0 = blockIdx.x * PROD_M;
  const int o0 = blockIdx.y * PROD_F32_N;
  const int tx = threadIdx.x % 16;    // columns o0 + tx*4 .. +3
  const int ty = threadIdx.x / 16;    // rows r0 + ty*4 .. +3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += PROD_K) {
    for (int i = threadIdx.x; i < PROD_K * PROD_M; i += PROD_THREADS) {
      const int r = i / PROD_K, kk = i % PROD_K;
      as[kk][r] = k0 + kk < K ? a[(size_t)(r0 + r) * lda + k0 + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < PROD_K * PROD_F32_N; i += PROD_THREADS) {
      const int kk = i / PROD_F32_N, c = i % PROD_F32_N;
      bs[kk][c] = (k0 + kk < K && o0 + c < n) ? w[(size_t)(k0 + kk) * n + o0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < PROD_K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < n)
        y[(size_t)(r0 + ty * 4 + i) * n + o] =
            bias != nullptr ? acc[i][j] + bias[o] : acc[i][j];
    }
  }
}

// y (rows, n) f32 = a (rows, lda; K columns read) . w (+ bias).  rows a
// multiple of 64.  bf16 != 0: a and w bf16, lda and ldw multiples of 8, w
// (K, ldw) zero past n; else f32, w (K, n).  Returns the cudaError_t of the
// launch (0 = launched).
template <typename Tag>
int launch_product(const void* a, int lda, const void* w, int ldw, const float* bias, float* y,
                   int rows, int K, int n, int bf16, cudaStream_t stream) {
  if (bf16) {
    dim3 grid(rows / PROD_M, (n + PROD_N - 1) / PROD_N);
    pw_product_kernel<Tag><<<grid, PROD_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a), lda, static_cast<const __nv_bfloat16*>(w), ldw,
        bias, y, K, n);
  } else {
    dim3 grid(rows / PROD_M, (n + PROD_F32_N - 1) / PROD_F32_N);
    pw_product_f32_kernel<Tag><<<grid, PROD_THREADS, 0, stream>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(w), bias, y, K, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace pw
