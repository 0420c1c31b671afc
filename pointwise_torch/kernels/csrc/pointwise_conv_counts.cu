// pointwise_conv_counts.cu — per-cell neighbor counts for Hopper (sm_90a).
//
// Replaces _counts_kernel (:1317, called by _counts_call :1345) of
// pointwise_tpu/kernels/pointwise_conv_pallas.py: for every center i and
// cell k, cnt[i][k] = sum_j [pair_code(c_i, p_j) == k] over the real
// candidates j.  Geometry only: no features, no product.  It is the ring
// strategy's pre-pass (parallel/spatial.py): counts over the all-gathered
// points, which the forward then divides by (its cnt_in flag).
//
// Design.  The forward's walk without the sums: a block owns CPB = 8
// consecutive centers, one warp each, and walks every candidate tile
// (tile_idx == nullptr, the dense walk) or the listed ones (the CSR walk,
// the same list as the forward's).  For each tile it stages the 64
// candidates' coordinates in shared memory; each lane computes the cell
// code of one candidate against its warp's center with the shared
// pair_code (pointwise_conv_common.cuh), so every pair lands in the cell the
// forward bins it into.  A group of 32 codes with no in-ball pair is
// skipped after one ballot; otherwise 27 ballots count the group's pairs of
// each cell, and lane k adds the population count of cell k to its
// integer count.  Counts are integers below 2^24, so they equal the
// forward's f32 counts (one 1.f added per pair) bit for bit.  Each output
// row has one owner and no atomics.
//
// What bounds it on an H100: the tested pairs of the walk (3 subtractions,
// 3 multiplications, 2 additions and a comparison each on the CUDA cores)
// against the bytes of the coordinates and counts; the 27 ballots per group
// with an in-ball pair are the issue cost above that.  Speed is later work.

#include "pointwise_conv_common.cuh"

namespace {

using namespace pw;

__global__ void __launch_bounds__(THREADS)
pw_counts_kernel(const float* __restrict__ ctr,      // (B, Ncp, 3)
                 const float* __restrict__ pts,      // (B, Mp, 3)
                 const int* __restrict__ tile_ptr,   // (B * Ncp/TILE + 1) or null
                 const int* __restrict__ tile_idx,   // (tile_ptr[-1],) or null
                 float* __restrict__ cnt_out,        // (B, Ncp, 27)
                 int Ncp, int Mp, float radius, float inv) {
  __shared__ float cxyz[TILE * 3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int n_rows = Ncp / TILE;
  const int row = c0 / TILE;

  const float* cp = ctr + ((size_t)b * Ncp + c0 + warp) * 3;
  const float px = cp[0], py = cp[1], pz = cp[2];
  const float r2 = __fmul_rn(radius, radius);

  const int* list = nullptr;
  int n_walk = Mp / TILE;
  if (tile_idx != nullptr) {
    const int beg = tile_ptr[b * n_rows + row];
    list = tile_idx + beg;
    n_walk = tile_ptr[b * n_rows + row + 1] - beg;
  }
  const float* pb = pts + (size_t)b * Mp * 3;

  int mine = 0;   // lane k < 27: the count of cell k
  for (int t = 0; t < n_walk; ++t) {
    const int jt = list != nullptr ? list[t] : t;
    __syncthreads();   // previous tile consumed
    for (int i = threadIdx.x; i < TILE * 3; i += THREADS)
      cxyz[i] = pb[(size_t)jt * TILE * 3 + i];
    __syncthreads();
#pragma unroll
    for (int j0 = 0; j0 < TILE; j0 += 32) {
      const int j = j0 + lane;
      const int code = pair_code(cxyz[j * 3 + 0], cxyz[j * 3 + 1], cxyz[j * 3 + 2],
                                 px, py, pz, r2, radius, inv);
      const bool ok = code >= 0 && code < N_CELLS;
      if (__ballot_sync(0xffffffffu, ok) == 0u) continue;
#pragma unroll
      for (int k = 0; k < N_CELLS; ++k) {
        const unsigned m = __ballot_sync(0xffffffffu, ok && code == k);
        if (lane == k) mine += __popc(m);
      }
    }
  }
  if (lane < N_CELLS)
    cnt_out[((size_t)b * Ncp + c0 + warp) * N_CELLS + lane] = (float)mine;
}

}  // namespace

extern "C" {

// Counts only.  Ncp and Mp must be multiples of TILE.  tile_ptr/tile_idx null
// = dense walk.  Returns the cudaError_t of the launch (0 = launched).
int pw_conv_counts(const void* ctr, const void* pts, const void* tile_ptr,
                   const void* tile_idx, void* cnt, int B, int Ncp, int Mp,
                   float radius, float inv, void* stream) {
  dim3 grid(Ncp / CPB, B);
  pw_counts_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ctr), static_cast<const float*>(pts),
      static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
      static_cast<float*>(cnt), Ncp, Mp, radius, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
