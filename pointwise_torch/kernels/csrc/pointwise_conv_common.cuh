// pointwise_conv_common.cuh — device code shared by the pointwise-conv
// kernels (pointwise_conv_{fwd,dw,dx,counts}.cu).
//
//   pair_code     the cell code of one (center, candidate) pair, bit for bit
//                 the TPU's _pairwise_code (pointwise_conv_pallas.py:140);
//   block_product out[i][:] = A[i][:] . W (+ bias) for the block's CPB rows,
//                 the (27*Cout) x Cin product the dX kernel ends with (f32
//                 FMAs on the CUDA cores; the forward and dW run their
//                 products on tensor cores, pointwise_conv_walk.cuh).
//
// The forward's and dW's means walk (tensor cores) lives in
// pointwise_conv_walk.cuh; dX and counts keep their CUDA-core walks.
//
// Exactness of the cell code (_pairwise_code :140-168): rel = candidate -
// center in f32; d2 = rx*rx + ry*ry + rz*rz summed in that order; valid iff
// d2 <= r*r; c = min(floor((rel + r) * inv), 2) per axis; code = (cx*3 +
// cy)*3 + cz.  The geometry uses __fmul_rn / __fadd_rn / __fsub_rn so nvcc
// cannot contract d2 into FMAs, which would move pairs at exactly distance r
// (and on cell faces) into other cells or out of the ball.  Like the TPU
// kernel there is no lower clamp: a valid pair whose code falls outside
// [0, 27) matches no cell.  Every kernel takes rel as candidate - center,
// whichever of the two its warps own, so gradients route through exactly
// the cells the forward binned into.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pw {

constexpr int N_CELLS = 27;
constexpr int TILE = 64;      // walk tile and row tile (points)
constexpr int CPB = 8;        // rows (centers or candidates) per block, one warp each
constexpr int THREADS = CPB * 32;
constexpr int HALF = THREADS / 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the matmul type T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_like(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ int axis_cell(float rel, float radius, float inv) {
  return (int)fminf(floorf(__fmul_rn(__fadd_rn(rel, radius), inv)), 2.0f);
}

// Cell code of candidate q against center p: in [0, 27) for an in-ball pair
// (outside it only for codes the TPU kernel also drops), N_CELLS otherwise.
__device__ __forceinline__ int pair_code(float qx, float qy, float qz, float px,
                                         float py, float pz, float r2, float radius,
                                         float inv) {
  const float rx = __fsub_rn(qx, px);
  const float ry = __fsub_rn(qy, py);
  const float rz = __fsub_rn(qz, pz);
  float d2 = __fmul_rn(rx, rx);
  d2 = __fadd_rn(d2, __fmul_rn(ry, ry));
  d2 = __fadd_rn(d2, __fmul_rn(rz, rz));
  int code = N_CELLS;
  if (d2 <= r2) {   // |rel| <= r(1+eps): the int casts below are safe
    code = (axis_cell(rx, radius, inv) * 3 + axis_cell(ry, radius, inv)) * 3
           + axis_cell(rz, radius, inv);
  }
  return code;
}

// out[i * out_stride + o] = sum_kc A[i*K + kc] * W[kc*N + o] (+ bias[o]) for
// the block's CPB rows i.  Thread t owns output column t % HALF (of each
// HALF-wide column block) for all CPB rows over one half of the K reduction;
// the two halves add in a fixed order, then the bias.  A lives in shared
// memory; part holds CPB*HALF floats of shared scratch.
template <typename T>
__device__ void block_product(const float* A, const T* __restrict__ W,
                              const float* __restrict__ bias, float* __restrict__ out,
                              int out_stride, int K, int N, float* part) {
  const int h = threadIdx.x / HALF;
  const int kbeg = h == 0 ? 0 : K / 2;
  const int kend = h == 0 ? K / 2 : K;
  for (int o0 = 0; o0 < N; o0 += HALF) {
    const int oo = threadIdx.x % HALF;
    const int o = o0 + oo;
    float acc[CPB];
#pragma unroll
    for (int i = 0; i < CPB; ++i) acc[i] = 0.f;
    if (o < N) {
      for (int kc = kbeg; kc < kend; ++kc) {
        const float wv = to_f32(W[(size_t)kc * N + o]);
#pragma unroll
        for (int i = 0; i < CPB; ++i) acc[i] = fmaf(A[i * K + kc], wv, acc[i]);
      }
    }
    if (h == 1) {
#pragma unroll
      for (int i = 0; i < CPB; ++i) part[i * HALF + oo] = acc[i];
    }
    __syncthreads();
    if (h == 0 && o < N) {
      if (bias != nullptr) {
        const float bo = bias[o];
#pragma unroll
        for (int i = 0; i < CPB; ++i)
          out[(size_t)i * out_stride + o] = (acc[i] + part[i * HALF + oo]) + bo;
      } else {
#pragma unroll
        for (int i = 0; i < CPB; ++i)
          out[(size_t)i * out_stride + o] = acc[i] + part[i * HALF + oo];
      }
    }
    __syncthreads();
  }
}

}  // namespace pw
