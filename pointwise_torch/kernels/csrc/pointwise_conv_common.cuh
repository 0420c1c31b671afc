// pointwise_conv_common.cuh — device code shared by the pointwise-conv
// kernels (pointwise_conv_{fwd,dw,dx,counts}.cu).
//
//   pair_code     the cell code of one (center, candidate) pair, bit for bit
//                 the TPU's _pairwise_code (pointwise_conv_pallas.py:140).
//
// The tensor-core walk of the forward, dW and dX lives in
// pointwise_conv_walk.cuh, the product of the forward and dX in
// pointwise_conv_product.cuh; the counts kernel keeps its CUDA-core walk.
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
constexpr int CPB = 8;        // centers per counts block, one warp each
constexpr int THREADS = CPB * 32;

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

}  // namespace pw
