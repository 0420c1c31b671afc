// pointwise_conv_counts.cu — per-cell neighbor counts for Hopper (sm_90a).
//
// Replaces _counts_kernel (:1317, called by _counts_call :1345, pallas_call
// :1348) of pointwise_tpu/kernels/pointwise_conv_pallas.py: for every center
// i and cell k, cnt[i][k] = sum_j [pair_code(c_i, p_j) == k] over the real
// candidates j.  Geometry only: no features, no product.  It is the ring
// strategy's pre-pass (parallel/spatial.py): counts over the all-gathered
// points, which the forward then divides by (its cnt_in flag).
//
// What bounds it on an H100: the tested pairs at 9 f32 operations each (3
// subtractions, 3 multiplications, 2 additions, a comparison) on the CUDA
// cores' 67 TFLOP/s, against the bytes of the coordinates, the tile list
// and the counts at 3.35 TB/s.  At the ring's shapes the operations bound
// it.  Above that bound: the cell code of an in-ball pair (per axis an add,
// a multiply, a floor, a clamp and a conversion) and the count's increment,
// each pair one thread's instructions.  The SASS spends about 32
// thread instructions on an in-ball pair, six of them (3 FRND.FLOOR, 3
// F2I) on the conversion pipe, which runs 16 lanes per clock per SM
// against the FMA pipe's 128: those two, not the barriers or the staging,
// hold the kernel far above its bound.  pair_code stays the forward's own
// (the counts must bin as the walk does); a floor without the conversion
// pipe would have to change it for every kernel.
//
// Design: instructions per pair, and few barriers.
//   * A block owns one 64-center row of the tile list: every candidate tile
//     (tile_idx == nullptr, the dense walk) or the row's CSR entry.  Each
//     listed tile is staged once per row.  At the rings' shapes that is
//     256 blocks for 132 SMs; no block shares a row, so each writes its
//     counts with plain stores.
//   * Its THREADS = 256 threads are (center c, split s), c = tid % 64,
//     s = tid / 64.  A warp is 32 centers on one split, so all its lanes
//     read the same candidate from shared memory (a broadcast).
//   * Candidates arrive STAGE_TILES = 8 tiles (512 candidates, 6 KB) at a
//     time by cp.async into two buffers: the next stage is in flight while
//     this one is binned, and one __syncthreads per stage orders both.
//   * Split s takes the runs of RUN = 4 consecutive candidates at 16q + 4s
//     of the stage (three 16-byte shared loads per run), so every stage,
//     a short last one too, splits evenly.
//   * Each thread computes pair_code (pointwise_conv_common.cuh, unchanged,
//     so every pair lands in the cell the forward bins it into) and, for
//     0 <= code < 27, adds one to hist[code][tid]: an int32 histogram in
//     shared memory whose [27][256] layout puts a warp's increments on 32
//     distinct banks.  No vote and no atomic per pair.
//   * At the end of the row the 4 splits of each (center, cell) are summed
//     and written as f32.  The counts are integers below 2^24, so the sum
//     is exact in any order and equals the forward's f32 counts (one 1.f
//     added per pair) bit for bit.
// The first design (one warp per center, 8 centers a block, each
// 64-candidate tile staged per 8 centers behind two __syncthreads, 27
// __ballot_sync per 32-pair group holding an in-ball pair) took 0.5545 ms
// at 8 x 2048 centers of 4096 candidates (CSR) and 0.1547 ms at 32 x 512
// of 1024 (dense) on an H100 80GB HBM3 at 700 W, against bounds of 0.0088
// and 0.0023 ms.

#include "pointwise_conv_common.cuh"

namespace {

using namespace pw;

constexpr int SPLITS = 4;                    // candidate splits of a center
constexpr int THREADS = TILE * SPLITS;       // (center, split)
constexpr int STAGE_TILES = 8;               // candidate tiles per stage
constexpr int TILE_CHUNKS = TILE * 3 / 4;    // 16-byte chunks of a tile
constexpr int RUN = 4;                       // consecutive candidates a thread bins

__global__ void __launch_bounds__(THREADS)
pw_counts_kernel(const float* __restrict__ ctr,      // (B, Ncp, 3)
                 const float* __restrict__ pts,      // (B, Mp, 3), 16-byte aligned
                 const int* __restrict__ tile_ptr,   // (B * Ncp/TILE + 1) or null
                 const int* __restrict__ tile_idx,   // (tile_ptr[-1],) or null
                 float* __restrict__ cnt_out,        // (B, Ncp, 27)
                 int Ncp, int Mp, float radius, float inv) {
  __shared__ __align__(16) float cand[2][STAGE_TILES * TILE * 3];
  __shared__ int hist[N_CELLS * THREADS];
  const int tid = threadIdx.x;
  const int c = tid % TILE;
  const int s = tid / TILE;
  const int row = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rows = Ncp / TILE;

  const int* list = nullptr;
  int n_walk = Mp / TILE;
  if (tile_idx != nullptr) {
    const int beg = tile_ptr[b * n_rows + row];
    list = tile_idx + beg;
    n_walk = tile_ptr[b * n_rows + row + 1] - beg;
  }

  const float* pb = pts + (size_t)b * Mp * 3;
  const float* cp = ctr + ((size_t)b * Ncp + row * TILE + c) * 3;
  const float px = cp[0], py = cp[1], pz = cp[2];
  const float r2 = __fmul_rn(radius, radius);
  int* mine = hist + tid;   // hist[k][tid] = mine[k * THREADS]
#pragma unroll
  for (int k = 0; k < N_CELLS; ++k) mine[k * THREADS] = 0;

  // tiles [t0, t0 + STAGE_TILES) of the row's walk into buffer buf
  auto stage = [&](int buf, int t0) {
    const int n_chunks = min(STAGE_TILES, n_walk - t0) * TILE_CHUNKS;
    for (int q = tid; q < n_chunks; q += THREADS) {
      const int t = q / TILE_CHUNKS;
      const int jt = list != nullptr ? list[t0 + t] : t0 + t;
      cp_async16(&cand[buf][q * 4],
                 pb + ((size_t)jt * TILE_CHUNKS + q % TILE_CHUNKS) * 4, 16);
    }
    cp_async_commit();
  };

  if (n_walk > 0) stage(0, 0);
  int buf = 0;
  for (int t0 = 0; t0 < n_walk; t0 += STAGE_TILES, buf ^= 1) {
    cp_async_wait_all();
    // this stage has landed for every thread, and every thread is done
    // with the other buffer, which the next stage now overwrites
    __syncthreads();
    if (t0 + STAGE_TILES < n_walk) stage(buf ^ 1, t0 + STAGE_TILES);
    const int n_cand = min(STAGE_TILES, n_walk - t0) * TILE;
    const float4* cb = reinterpret_cast<const float4*>(cand[buf]);
    for (int j0 = s * RUN; j0 < n_cand; j0 += SPLITS * RUN) {
      // candidates j0..j0+3: 12 floats, three float4 (j0 * 3 % 4 == 0)
      const float4 a = cb[j0 * 3 / 4], e = cb[j0 * 3 / 4 + 1], f = cb[j0 * 3 / 4 + 2];
      const float qx[RUN] = {a.x, a.w, e.z, f.y};
      const float qy[RUN] = {a.y, e.x, e.w, f.z};
      const float qz[RUN] = {a.z, e.y, f.x, f.w};
      int code[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u)
        code[u] = pair_code(qx[u], qy[u], qz[u], px, py, pz, r2, radius, inv);
#pragma unroll
      for (int u = 0; u < RUN; ++u)
        if ((unsigned)code[u] < (unsigned)N_CELLS) mine[code[u] * THREADS] += 1;
    }
  }
  __syncthreads();   // every split's histogram complete

  float* out = cnt_out + ((size_t)b * Ncp + row * TILE) * N_CELLS;
  for (int o = tid; o < TILE * N_CELLS; o += THREADS) {
    const int cc = o / N_CELLS;
    const int k = o % N_CELLS;
    int sum = 0;
#pragma unroll
    for (int sp = 0; sp < SPLITS; ++sp) sum += hist[k * THREADS + sp * TILE + cc];
    out[o] = (float)sum;
  }
}

}  // namespace

extern "C" {

// Counts only.  Ncp and Mp must be multiples of TILE and pts 16-byte
// aligned.  tile_ptr/tile_idx null = dense walk.  Returns the cudaError_t
// of the launch (0 = launched).
int pw_conv_counts(const void* ctr, const void* pts, const void* tile_ptr,
                   const void* tile_idx, void* cnt, int B, int Ncp, int Mp,
                   float radius, float inv, void* stream) {
  dim3 grid(Ncp / TILE, B);
  pw_counts_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ctr), static_cast<const float*>(pts),
      static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
      static_cast<float*>(cnt), Ncp, Mp, radius, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
