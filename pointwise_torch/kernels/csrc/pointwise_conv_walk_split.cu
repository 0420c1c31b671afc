// pointwise_conv_walk_split.cu — an instrumented copy of the forward's
// means walk (pointwise_conv_walk.cuh, tag FwdMeans), built only by
// pointwise_torch/tools/walk_split.py into its own directory; the kernel
// module never builds it.  PW_WALK_SPLIT turns on the walk's clock stamps:
// each warp adds the cycles it spends in each part of its loop (the codes,
// the staging copies, the waits on staging and on the barriers, the cell
// tests and planes, the MMAs, the epilogue) into pw_split_cycles.

#define PW_WALK_SPLIT
#include "pointwise_conv_walk.cuh"

using namespace pw;

extern "C" {

int pw_split_parts() { return PART_COUNT; }

// Zero the cycle counters.  Returns the cudaError_t.
int pw_split_reset() {
  const unsigned long long zero[PART_COUNT] = {};
  return (int)cudaMemcpyToSymbol(pw_split_cycles, zero, sizeof zero);
}

// The cycle counters (PART_COUNT of them, summed over warps) into out.
int pw_split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, pw_split_cycles,
                                   sizeof(unsigned long long) * PART_COUNT);
}

// The forward's means walk with the stamps on: pw_conv_fwd_means's
// arguments (pointwise_conv_fwd.cu), bf16 features only.
int pw_split_fwd_means(const void* ctr, const void* pts, const void* feats, void* packed,
                       const void* tile_ptr, const void* tile_idx, void* cnt, void* xbar,
                       int ldx, int B, int Ncp, int Mp, int cin, float radius, float inv,
                       void* stream) {
  return launch_walk<FwdMeans, __nv_bfloat16>(
      static_cast<const float*>(ctr), static_cast<const float*>(pts), feats,
      static_cast<__nv_bfloat16*>(packed), nullptr, static_cast<const int*>(tile_ptr),
      static_cast<const int*>(tile_idx), nullptr, static_cast<float*>(cnt),
      static_cast<__nv_bfloat16*>(xbar), ldx, B, Ncp, Mp, cin, radius, inv,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
