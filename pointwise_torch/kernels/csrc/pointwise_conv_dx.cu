// pointwise_conv_dx.cu — feature gradient of the pointwise convolution for
// Hopper (sm_90a).
//
// Replaces the dX Pallas kernels of
// pointwise_tpu/kernels/pointwise_conv_pallas.py:
//   _dx_kernel_resident_flip (:527) / _dx_kernel_resident (:495)
//       + _dx_finalize (:476)       dense walk, centers resident in VMEM
//   _dx_kernel_flip (:914) / _dx_kernel (:877)
//                                   dense walk over a (B, Mp/tmo, Nc/tni) grid
//   _dx_kernel_csr_flip (:748) / _dx_kernel_csr (:709)
//                                   walk over the bbox-adjacent center tiles
// which all compute, for every candidate j,
//   Z_k[j] = sum over centers i with code(i, j) = k of
//            round(1 / max(cnt_ik, 1)) * round(g_i)
//   dx_j   = sum_k round(Z_k[j]) . W_k^T
// (the flipped and unflipped variants are two MXU layouts of it) with ONE
// kernel: the forward with the roles of centers and candidates swapped.
//
// Design.  A block owns CPB = 8 consecutive candidates, one warp each, and
// walks every center tile (tile_idx == nullptr) or the transposed CSR list,
// tile_idx[tile_ptr[b * n_cand_tiles + row] : ...+1] (from tile_adjacency
// with candidates as rows).  For each center tile (TILE = 64) it stages the
// centers' coordinates, their gradient rows round(g_i) and the rounded
// reciprocal counts in shared memory; each warp's lanes test 32 centers at
// a time against its candidate, ballot the in-ball ones and, for each of
// them in ascending center order, add s * g_i[:] into the candidate's
// Z[k][:] (27 x Cout f32 in shared memory, lane o owning columns o, o+32,
// ...).  Then Z is rounded to the matmul type and the block forms
// dx = Z . W^T (block_product, shared with the forward).  Every output row
// has one owner and every sum runs in a fixed order: no atomics, so dX
// repeats bit for bit from run to run, and the dense and CSR walks give
// identical bits (the list only drops tiles without in-ball pairs).
//
// The cell code is computed with rel = candidate - center by the same
// __fsub_rn / __fmul_rn / __fadd_rn sequence as the forward (pair_code), so
// pairs at exactly r and on cell faces route gradient through exactly the
// cells the forward binned them into (the TPU's flip note, _pairwise_code
// :150-154).
//
// What bounds it on an H100.  As the forward: every in-ball pair costs Cout
// f32 FMAs into shared memory (the operations bound chip_smoke.py reports is
// pairs * Cout at 67 TFLOP/s), run as a ballot/shuffle step plus Cout/32
// shared-memory read-modify-writes per lane, with one 150 KB block (8
// warps) per SM: bound by instruction throughput and latency.  The
// product reads W^T (27*Cout*Cin) from L2 once per 8 candidates.
//
// Rounding (the TPU op's _pw_bwd :1295-1308): g arrives in f32 and is
// rounded to the matmul type; 1/max(cnt, 1) is divided in f32 and rounded;
// Z accumulates in f32 and is rounded before the product; W^T is in the
// matmul type; dx accumulates and is stored in f32 (the wrapper casts it to
// the features' type).
//
// The C entry point checks the launch with cudaGetLastError and returns the
// code; the Python wrapper raises on anything but 0.

#include "pointwise_conv_common.cuh"

namespace {

using namespace pw;

template <typename T>
__global__ void __launch_bounds__(THREADS)
pw_dx_kernel(const float* __restrict__ ctr,     // (B, Ncp, 3)
             const float* __restrict__ pts,     // (B, Mp, 3)
             const float* __restrict__ g,       // (B, Ncp, cout)
             const float* __restrict__ cnt,     // (B, Ncp, 27), the forward's
             const T* __restrict__ wt,          // (27, cout, cin)
             const int* __restrict__ tile_ptr,  // (B * Mp/TILE + 1) or null
             const int* __restrict__ tile_idx,  // (tile_ptr[-1],) or null
             float* __restrict__ dx,            // (B, Mp, cin)
             int Ncp, int Mp, int cin, int cout, float radius, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int K = N_CELLS * cout;
  float* z = smem;                       // CPB * K
  float* part = z + CPB * K;             // CPB * HALF (product halves)
  float* cxyz = part + CPB * HALF;       // TILE * 3
  float* gt = cxyz + TILE * 3;           // TILE * cout, rounded
  float* sinv = gt + TILE * cout;        // TILE * 27, rounded

  const int b = blockIdx.y;
  const int j0 = blockIdx.x * CPB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_ctr_tiles = Ncp / TILE;
  const int n_rows = Mp / TILE;
  const int row = j0 / TILE;

  for (int i = threadIdx.x; i < CPB * K; i += THREADS) z[i] = 0.f;

  const float* qp = pts + ((size_t)b * Mp + j0 + warp) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float r2 = __fmul_rn(radius, radius);
  float* my_z = z + warp * K;

  const int* list = nullptr;
  int n_walk = n_ctr_tiles;
  if (tile_idx != nullptr) {
    const int beg = tile_ptr[b * n_rows + row];
    list = tile_idx + beg;
    n_walk = tile_ptr[b * n_rows + row + 1] - beg;
  }

  for (int t = 0; t < n_walk; ++t) {
    const int it = list != nullptr ? list[t] : t;
    const size_t i0 = (size_t)b * Ncp + (size_t)it * TILE;   // first center
    __syncthreads();   // zeroing done / previous tile consumed
    for (int i = threadIdx.x; i < TILE * 3; i += THREADS) cxyz[i] = ctr[i0 * 3 + i];
    for (int i = threadIdx.x; i < TILE * cout; i += THREADS)
      gt[i] = round_like<T>(g[i0 * cout + i]);
    for (int i = threadIdx.x; i < TILE * N_CELLS; i += THREADS)
      sinv[i] = round_like<T>(__frcp_rn(fmaxf(cnt[i0 * N_CELLS + i], 1.f)));
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += 32) {
      const int c = c0 + lane;
      const int code = pair_code(qx, qy, qz, cxyz[c * 3 + 0], cxyz[c * 3 + 1],
                                 cxyz[c * 3 + 2], r2, radius, inv);
      unsigned m = __ballot_sync(0xffffffffu, code >= 0 && code < N_CELLS);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int k = __shfl_sync(0xffffffffu, code, src);
        const float s = sinv[(c0 + src) * N_CELLS + k];
        const float* grow = gt + (c0 + src) * cout;
        float* zrow = my_z + k * cout;
        for (int o = lane; o < cout; o += 32) zrow[o] = __fmaf_rn(s, grow[o], zrow[o]);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < CPB * K; i += THREADS) z[i] = round_like<T>(z[i]);
  __syncthreads();

  block_product<T>(z, wt, nullptr, dx + ((size_t)b * Mp + j0) * cin, cin, K, cin, part);
}

size_t smem_bytes(int cout) {
  return sizeof(float) * ((size_t)CPB * (N_CELLS * cout + HALF) + TILE * 3
                          + (size_t)TILE * cout + TILE * N_CELLS);
}

template <typename T>
int launch(const float* ctr, const float* pts, const float* g, const float* cnt,
           const void* wt, const int* tile_ptr, const int* tile_idx, float* dx, int B,
           int Ncp, int Mp, int cin, int cout, float radius, float inv,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(cout);
  cudaError_t err = cudaFuncSetAttribute(
      pw_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pw_dx_kernel<T><<<dim3(Mp / CPB, B), THREADS, smem, stream>>>(
      ctr, pts, g, cnt, static_cast<const T*>(wt), tile_ptr, tile_idx, dx, Ncp, Mp,
      cin, cout, radius, inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (bytes); the wrapper refuses
// widths above the card's 227 KB per block.
long long pw_dx_smem_bytes(int cout) { return (long long)smem_bytes(cout); }

// Feature gradient.  Ncp and Mp must be multiples of TILE; tile_ptr/tile_idx
// null = dense walk, else the candidate-tile -> center-tile list.  wt is
// (27, cout, cin) in bf16 when bf16 != 0, else f32; g, cnt and dx are f32.
// Returns the cudaError_t of the launch (0 = launched).
int pw_conv_dx(const void* ctr, const void* pts, const void* g, const void* cnt,
               const void* wt, const void* tile_ptr, const void* tile_idx, void* dx,
               int B, int Ncp, int Mp, int cin, int cout, float radius, float inv,
               int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(static_cast<const float*>(ctr), static_cast<const float*>(pts),
                     static_cast<const float*>(g), static_cast<const float*>(cnt), wt,
                     static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
                     static_cast<float*>(dx), B, Ncp, Mp, cin, cout, radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

}  // extern "C"
