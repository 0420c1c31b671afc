// pointwise_conv_walk.cuh — the tensor-core walk shared by the forward
// (pointwise_conv_fwd.cu), the weight gradient (pointwise_conv_dw.cu) and
// the feature gradient (pointwise_conv_dx.cu), and the PTX helpers
// (ldmatrix, mma.sync) of all three.
//
// Replaces the walks of pointwise_tpu/kernels/pointwise_conv_pallas.py:
// _fwd_kernel_resident (:320), _fwd_kernel (:268) and _fwd_kernel_csr
// (:599) with their external-counts variants, the dW kernels' (:396, :842,
// :636) and the dX kernels' (:495-914; tag DxSums, below).
//
// What it computes.  For every center i and cell k, the mean of the feature
// rows of the in-ball candidates j with pair_code(i, j) == k, divided in f32
// by max(count, 1) (or by max(cnt_in, 1)) and rounded to the matmul type T,
// into a workspace xbar (B*Ncp rows, row stride ldx, column k*cin + c); and
// the per-cell counts.  The TPU kernel's formulation (_bin_accumulate
// :220 and _foreach_mask :171 of pointwise_conv_pallas.py): per cell, a 0/1
// plane times the features on the matrix unit, never a scatter.
//
// Design.  A CTA owns WALK_M = 16 centers (one m16 MMA row tile) and walks
// their row tile's candidate tiles (every tile, or the CSR list) in
// ascending order, two list entries (128 candidates) per iteration in bf16
// and one in f32.  Per iteration it
//   * computes the 16 x 128 cell codes (pair_code, unchanged) into shared
//     bytes, laid out so that each lane reads the 8 codes of its mma.sync
//     A fragment with one 8-byte load (0xFF: no cell), and marks the
//     16-candidate k-steps that hold a pair of one of the CTA's cells;
//   * stages, with cp.async, the feature rows of those live k-steps only;
//     the codes run one iteration ahead, so the features land while the
//     iteration before is summed, and the coordinates two ahead;
//   * for each live k-step and each of the warp's cells, builds the 0/1
//     bf16 A fragment from the codes with __vcmpeq4/__byte_perm, skips the
//     cell when __any_sync finds no pair of it in the 16 x 16 block, and
//     otherwise runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) against
//     the staged features, B fragments by ldmatrix.trans.
// The sums stay in f32 registers with static indices.  16 centers x 27
// cells x 128 channels of f32 would take nearly a whole register file, so
// the (cell, channel) space is split: a warp owns CW cells x NT n8-tiles
// (CW * NT = 16, 64 accumulator registers), NT the smallest power of two
// (<= 16) that holds Cin + 1 columns, so the one A fragment of a cell feeds
// NT MMAs.  The warps of a center tile spread over `ctas` CTAs of at most
// 9 warps (at Cin = 124: NT = 16, one cell per warp, 3 CTAs of 9 warps,
// CTA c holding the cells of x-third c of the ball, so it stages about a
// third of the k-steps; at Cin = 3 or 6: NT = 1, 16 cells per warp, one CTA
// of 2 warps); wider features take `ng` channel groups of NT*8 - 1
// channels.  Each CTA computes its own codes: one pair_code per listed
// entry per CTA.
//
// Counts.  The last staged column of each channel group is 1.0, so its MMA
// column sums the plane: the count of each (center, cell), an integer sum
// of 1 x 1 products, exact in the f32 accumulator (below 2^24) and so
// equal to conv_counts bit for bit.
//
// f32 mode.  A pack kernel splits each f32 feature into three bf16 terms,
// hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid), whose sum is x
// exactly (for |x| up to bf16's largest finite value, 3.39e38); the walk
// runs three MMAs per n8-tile against the same exact 0/1 plane.  bf16 mode
// stages the features as they are (one term).
//
// dX (tag DxSums).  The same walk with the roles swapped, as the TPU's
// _dx_kernel_resident_flip (:527) builds its planes with candidates as
// rows: the rows are 16 candidates, the columns the centers of the
// transposed tile list, the staged operand is round(g) (Cout wide), and
// each plane's ones are replaced by the column's scale
// s[k][i] = round(1/max(cnt[i][k], 1)) (the TPU's col_scale, _foreach_mask
// :210-214).  A pre-pass (pw_walk_scale_kernel) writes the scales as bf16
// [terms][B][27][Nc]; each live k-step stages the 16 scales of each of the
// CTA's cells beside its g rows, and a lane ANDs its plane masks with the
// two packed bf16 pairs of its columns (2tq, 2tq+1 and 2tq+8, 2tq+9).  The
// cell code keeps the forward's operands, pair_code(candidate, center),
// so a pair routes its gradient through the cell the forward binned it
// into.  The epilogue writes round(Z) to the workspace with no division;
// the per-cell product with W^T follows (pointwise_conv_product.cuh).  In
// f32 mode s and g are each split into three exact bf16 terms: their nine
// products are exact in f32.
//
// Order and bits.  Every (center, cell, channel) sum has one owner thread
// and runs in the walk's tile order, so results repeat bit for bit; a tile
// the CSR list drops holds no in-ball pair, so the dense walk skips every
// cell of it and both walks give identical bits.
//
// What bounds it on an H100: latency and instruction issue, not bytes or
// MMAs.  The accumulators of 16 centers (27 x 128 f32 each) fill most of an
// SM's registers, so an SM runs 2 CTAs (18 warps), and each iteration's
// chains run in turn between two barriers.  The split of its warps' cycles
// (pointwise_torch/tools/walk_split.py, PERF.md; an H100 SXM at 700 W) at
// layer 2 of a 1M-point request (Cin 124): the codes 50% (one pair_code per listed pair in each
// of the 3 CTAs of a center tile), the cp.async staging 33%, the cell tests
// 6%, the waits on the barriers 3%, the MMAs 2%; at Cin 6 the codes 35% and
// the tests 47%.
//
// The forward's bf16 walk at NT = 16 (Cin > 56; walk_tma) stages its
// features by TMA instead of cp.async: the packed features are a 2-D
// tensor map {128 columns, terms*B*ng*Mp rows}, and one thread issues, per
// live k-step, two boxes of 16 rows by 64 columns (the 128-byte swizzle)
// into a 1024-aligned buffer, completing on that buffer's full mbarrier;
// the warps wait on it just before they sum, and read their B fragments by
// ldmatrix.trans at the swizzled addresses.  That takes the issue of 2,048
// cp.async a CTA-iteration (and their address arithmetic) off every warp;
// with each warp reading the live k-steps as one byte a lane and one OR
// over the warp (at Cin 6 that read was 1% slower than the loop it keeps),
// the walk at layer 2 of the 1M request falls from 26.5 to 22.5 ms on the
// same H100.  Tried
// and slower (PERF.md): the codes shared by the 3 CTAs of a center tile
// through a cluster (each computes a third and stores it into all three
// over DSMEM; the cluster barrier costs more than the codes it saves), and
// an axis cell from three compares in place of floor and min (more
// instructions than the conversion pipe's two).  dW's and dX's walks keep
// the cp.async staging.

#pragma once

#include <string.h>
#include <type_traits>

#include "pointwise_conv_common.cuh"

namespace pw {

constexpr int WALK_M = 16;          // centers per walk CTA
constexpr int WALK_MAX_WARPS = 9;   // warps per walk CTA, at most
constexpr int MAX_WIDTH = 1024;     // widest Cin (and forward Cout) accepted
constexpr unsigned NO_CELL = 0xFFu;

// The walk's time split, built only into the instrumented copy of
// pointwise_torch/tools/walk_split.py (csrc/pointwise_conv_walk_split.cu
// defines PW_WALK_SPLIT): each warp adds the clock cycles of each part of
// its loop (WalkPart) into pw_split_cycles, summed over every warp; the
// main build compiles none of it.
enum WalkPart { PART_CODES, PART_STAGE, PART_WAIT, PART_TESTS, PART_MMA, PART_EPILOGUE,
                PART_COUNT };
#ifdef PW_WALK_SPLIT
__device__ unsigned long long pw_split_cycles[PART_COUNT];
#define PW_SPLIT_BEGIN                  \
  unsigned split_t = (unsigned)clock(); \
  unsigned split_acc[PART_COUNT] = {};
#define PW_SPLIT(part)                            \
  {                                               \
    const unsigned split_now = (unsigned)clock(); \
    split_acc[part] += split_now - split_t;       \
    split_t = split_now;                          \
  }
#define PW_SPLIT_END                                                          \
  if ((threadIdx.x & 31) == 0)                                                \
    for (int split_p = 0; split_p < PART_COUNT; ++split_p)                    \
      atomicAdd(&pw_split_cycles[split_p], (unsigned long long)split_acc[split_p]);
#else
#define PW_SPLIT_BEGIN
#define PW_SPLIT(part)
#define PW_SPLIT_END
#endif

// Tags of the walk's three callers: the kernels' names (and so the traces)
// tell the forward's walk from dW's and dX's.
struct FwdMeans {};
struct DwMeans {};
struct DxSums {};

template <typename Tag>
struct IsDx { static constexpr bool value = false; };
template <>
struct IsDx<DxSums> { static constexpr bool value = true; };

template <typename T>
struct Terms;
template <>
struct Terms<float> { static constexpr int value = 3; };
template <>
struct Terms<__nv_bfloat16> { static constexpr int value = 1; };

// Candidates per walk iteration: two list entries in bf16, one in f32
// (whose three feature terms fill the shared memory of one).
template <typename T>
struct WalkRows;
template <>
struct WalkRows<float> { static constexpr int value = TILE; };
template <>
struct WalkRows<__nv_bfloat16> { static constexpr int value = 2 * TILE; };

// ---- PTX helpers (cp.async: pointwise_conv_common.cuh) -------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- layout ---------------------------------------------------------------

struct WalkShape {
  int nt;      // n8 tiles per warp (and per channel group)
  int ng;      // channel groups of nt*8 - 1 channels (+ the ones column)
  int warps;   // warps per CTA
  int ctas;    // CTAs per (center tile, channel group)
};

inline WalkShape walk_shape(int cin) {
  const int need = (cin + 1 + 7) / 8;
  int nt = 1;
  while (nt < need && nt < 16) nt *= 2;
  const int per = nt * 8 - 1;
  const int ncg = (N_CELLS + 16 / nt - 1) / (16 / nt);   // cell groups
  const int ctas = (ncg + WALK_MAX_WARPS - 1) / WALK_MAX_WARPS;
  return {nt, (cin + per - 1) / per, (ncg + ctas - 1) / ctas, ctas};
}

// bf16 elements of the packed features: [terms][B][ng][Mp][nt*8].
template <typename T>
size_t walk_pack_elems(int cin, int B, int Mp) {
  const WalkShape s = walk_shape(cin);
  return (size_t)Terms<T>::value * B * s.ng * Mp * s.nt * 8;
}

// bf16 elements of dX's scales: [terms][B][27][n].
template <typename T>
size_t walk_scale_elems(int B, int n) {
  return (size_t)Terms<T>::value * B * N_CELLS * n;
}

// The forward's bf16 walk at NT = 16 (Cin > 56) stages its features by TMA
// into 128-byte swizzled boxes (see the note at the top).
template <typename Tag, typename T>
__host__ __device__ constexpr bool walk_tma(int nt) {
  return std::is_same<Tag, FwdMeans>::value && std::is_same<T, __nv_bfloat16>::value &&
         nt == 16;
}
constexpr int WALK_TMA_KSTEP_BYTES = 16 * 128 * 2;   // one k-step: 16 rows x 128 columns

template <typename Tag, typename T>
size_t walk_smem_bytes(int cin) {
  const int sp = walk_shape(cin).nt * 8 + 8;
  const int rows = WalkRows<T>::value;
  const int sterms = IsDx<Tag>::value ? Terms<T>::value : 0;
  const bool tma = walk_tma<Tag, T>(walk_shape(cin).nt);
  return (tma ? 1024 + 2 * (rows / 16) * WALK_TMA_KSTEP_BYTES + 2 * 8   // aligned, barriers
              : sizeof(__nv_bfloat16) * 2 * Terms<T>::value * rows * sp)   // features
         + sizeof(__nv_bfloat16) * 2 * sterms * N_CELLS * rows     // dX's scales
         + sizeof(float) * 2 * rows * 3                             // coordinates
         + 2 * (rows / 16) * 32 * sizeof(uint2)                     // codes
         + sizeof(float) * WALK_M * 3                               // centers
         + 2 * 32;                                                  // live k-steps
}

// ---- kernels ---------------------------------------------------------------

// feats (B, Mp, cin) -> packed [terms][B][ng][Mp][nt*8] bf16: group g holds
// channels g*(nt*8-1) .. +nt*8-2 (zeros past cin) and 1.0 in its last
// column (in the first term only); f32 features split into hi, mid, lo.
// dX packs its f32 g (Tin = float) to the terms of T the same way.
template <typename Tag, typename T, typename Tin>
__global__ void pw_walk_pack_kernel(const Tin* __restrict__ feats,
                                    __nv_bfloat16* __restrict__ packed, int B, int Mp,
                                    int cin, int nt, int ng) {
  const int w = nt * 8, per = w - 1;
  const size_t n = (size_t)B * ng * Mp * w;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int lc = (int)(i % w);
    size_t r = i / w;
    const int j = (int)(r % Mp);
    r /= Mp;
    const int g = (int)(r % ng);
    const int b = (int)(r / ng);
    const int ch = g * per + lc;
    float x = 0.f;
    if (lc == per) {
      x = 1.f;
    } else if (ch < cin) {
      x = to_f32(feats[((size_t)b * Mp + j) * cin + ch]);
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    packed[i] = hi;
    if (Terms<T>::value == 3) {
      const float r1 = __fsub_rn(x, __bfloat162float(hi));
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      packed[n + i] = mid;
      packed[2 * n + i] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    }
  }
}

// dX's scales: cnt (B, n, 27) -> scl [terms][B][27][n] bf16 of
// 1/max(cnt, 1) (divided in f32, correctly rounded): rounded to bf16 in
// bf16 mode, split into hi, mid, lo in f32 mode.
template <typename Tag, typename T>
__global__ void pw_walk_scale_kernel(const float* __restrict__ cnt,
                                     __nv_bfloat16* __restrict__ scl, int B, int n) {
  const size_t total = (size_t)B * n * N_CELLS;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % N_CELLS);
    const size_t r = i / N_CELLS;
    const int j = (int)(r % n);
    const int b = (int)(r / n);
    const float x = __frcp_rn(fmaxf(cnt[i], 1.f));
    const size_t o = ((size_t)b * N_CELLS + k) * n + j;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    scl[o] = hi;
    if (Terms<T>::value == 3) {
      const float r1 = __fsub_rn(x, __bfloat162float(hi));
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      scl[total + o] = mid;
      scl[2 * total + o] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    }
  }
}

// The walk (see the note at the top).  Grid: x = (Ncp / WALK_M) row
// tiles x ng channel groups x ctas, y = B; block: warps * 32.  The rows
// are centers (ctr) and the columns candidates (pts), or for DxSums the
// rows candidates and the columns centers.
template <typename Tag, typename T, int NT>
__global__ void __launch_bounds__(WALK_MAX_WARPS * 32, 2)
pw_walk_kernel(const float* __restrict__ ctr,            // (B, Ncp, 3)
               const float* __restrict__ pts,            // (B, Mp, 3)
               const __nv_bfloat16* __restrict__ packed, // pw_walk_pack_kernel
               const __nv_bfloat16* __restrict__ scl,    // pw_walk_scale_kernel (dX) or null
               const int* __restrict__ tile_ptr,         // (B * Ncp/TILE + 1) or null
               const int* __restrict__ tile_idx,         // (tile_ptr[-1],) or null
               const float* __restrict__ cnt_in,         // (B, Ncp, 27) or null
               float* __restrict__ cnt_out,              // (B, Ncp, 27) or null
               T* __restrict__ xbar,                     // (B * Ncp, ldx)
               int ldx, int B, int Ncp, int Mp, int cin, int ng_total, int ctas,
               float radius, float inv,
               const __grid_constant__ CUtensorMap tma_f) {   // packed (walk_tma only)
  constexpr int CW = 16 / NT;           // cells per warp
  constexpr bool DX = IsDx<Tag>::value;
  constexpr int TERMS = Terms<T>::value;
  constexpr int STERMS = DX ? TERMS : 0;   // scale terms (dX)
  constexpr int ROWS = WalkRows<T>::value;   // candidates per iteration
  constexpr int SUB = ROWS / TILE;      // list entries per iteration
  constexpr int KS = ROWS / 16;         // k-steps per iteration
  constexpr int W8 = NT * 8;            // staged columns
  constexpr int SP = W8 + 8;            // padded shared row: ldmatrix rows on distinct banks
  constexpr unsigned ONE2 = 0x3F803F80u;   // two bf16 1.0
  constexpr bool TMA = walk_tma<Tag, T>(NT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA: [2][KS][2 halves][16 rows][128 bytes], 1024-aligned (the swizzle
  // atom), then the two buffers' full barriers; else [2][TERMS][ROWS][SP]
  unsigned char* fbase = smem_raw;
  if constexpr (TMA) fbase += (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(fbase);
  const unsigned full0 = smem_u32(fbase) + 2 * KS * WALK_TMA_KSTEP_BYTES;
  __nv_bfloat16* ss =
      TMA ? reinterpret_cast<__nv_bfloat16*>(fbase + 2 * KS * WALK_TMA_KSTEP_BYTES + 16)
          : fs + 2 * TERMS * ROWS * SP;   // [2][STERMS][27][ROWS] (dX)
  float* cxyz = reinterpret_cast<float*>(ss + 2 * STERMS * N_CELLS * ROWS);   // [2][ROWS*3]
  uint2* codes = reinterpret_cast<uint2*>(cxyz + 2 * ROWS * 3);         // [2][KS][32]
  float* pc = reinterpret_cast<float*>(codes + 2 * KS * 32);           // [WALK_M*3]
  unsigned char* live_w = reinterpret_cast<unsigned char*>(pc + WALK_M * 3);   // [2][32]

  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_tile = ng_total * ctas;
  const int ct = blockIdx.x / per_tile;
  const int rem = blockIdx.x - ct * per_tile;
  const int ng = rem / ctas;
  const int cg0 = (rem - ng * ctas) * nwarps;   // the CTA's first cell group
  const int cg = cg0 + warp;                    // this warp's
  const bool active = cg * CW < N_CELLS;
  const int cell_lo = cg0 * CW;                 // the CTA's cells: [cell_lo, cell_hi)
  const int cell_hi = min(cell_lo + nwarps * CW, N_CELLS);
  const int b = blockIdx.y;
  const int c0 = ct * WALK_M;
  const int n_rows = Ncp / TILE;
  const int row = c0 / TILE;

  const int* list = nullptr;
  int n_walk = Mp / TILE;
  if (tile_idx != nullptr) {
    const int beg = tile_ptr[b * n_rows + row];
    list = tile_idx + beg;
    n_walk = tile_ptr[b * n_rows + row + 1] - beg;
  }
  const int n_it = (n_walk + SUB - 1) / SUB;
  const float* pb = pts + (size_t)b * Mp * 3;
  const size_t term_stride = (size_t)B * ng_total * Mp * W8;
  const __nv_bfloat16* fb = packed + ((size_t)b * ng_total + ng) * Mp * W8;
  const float r2 = __fmul_rn(radius, radius);

  PW_SPLIT_BEGIN
  for (int i = threadIdx.x; i < WALK_M * 3; i += nthreads)
    pc[i] = ctr[((size_t)b * Ncp + c0) * 3 + i];
  const CUtensorMap* fmap = &tma_f;
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      mbar_init(full0, 1);
      mbar_init(full0 + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      tma_prefetch(fmap);
    }
  }

  // Iteration u walks list entries u*SUB .. u*SUB + SUB-1 (those < n_walk).
  auto tile_of = [&](int t) { return list != nullptr ? list[t] : t; };
  // Iteration u's coordinates into cxyz[buf] (cp.async, not committed).
  auto stage_xyz = [&](int u, int buf) {
    for (int c = threadIdx.x; c < SUB * TILE * 3 / 4; c += nthreads) {
      const int i = c / (TILE * 3 / 4), cc = c - i * (TILE * 3 / 4);
      if (u * SUB + i < n_walk)
        cp_async16(cxyz + buf * ROWS * 3 + c * 4,
                   pb + (size_t)tile_of(u * SUB + i) * TILE * 3 + cc * 4, 16);
    }
  };
  // Iteration u's feature rows into fs[buf], only those of the live k-steps
  // (bit s of `live`: k-step s holds a pair of one of the CTA's cells);
  // for dX also the scales of those k-steps' columns for the CTA's cells,
  // into ss[buf][term][cell - cell_lo].
  auto stage_feats = [&](int u, int buf, unsigned live) {
    for (int c = threadIdx.x; c < TERMS * ROWS * NT; c += nthreads) {
      const int term = c / (ROWS * NT);
      const int rr = c - term * ROWS * NT;
      const int j = rr / NT, q = rr - j * NT;
      if ((live >> (j >> 4)) & 1u)
        cp_async16(fs + ((buf * TERMS + term) * ROWS + j) * SP + q * 8,
                   fb + term * term_stride
                       + ((size_t)tile_of(u * SUB + j / TILE) * TILE + j % TILE) * W8
                       + q * 8,
                   16);
    }
    if constexpr (DX) {
      const int ncl = cell_hi - cell_lo;
      for (int c = threadIdx.x; c < STERMS * ncl * KS * 2; c += nthreads) {
        const int half = c & 1;
        const int s = (c >> 1) % KS;
        const int r = (c >> 1) / KS;
        const int kl = r % ncl, term = r / ncl;
        if ((live >> s) & 1u) {
          const int j = s * 16;
          cp_async16(ss + ((buf * STERMS + term) * N_CELLS + kl) * ROWS + j + half * 8,
                     scl + (((size_t)term * B + b) * N_CELLS + cell_lo + kl) * Mp
                         + (size_t)tile_of(u * SUB + j / TILE) * TILE + j % TILE + half * 8,
                     16);
        }
      }
    }
  };
  // TMA (one thread): iteration u's live k-steps into buffer buf, each as
  // two boxes of 16 rows by 64 columns, completing on buf's full barrier
  // (with no live k-step the arrival alone completes its phase).  The
  // buffer was last read by ldmatrix before the barrier that precedes this
  // call; the proxy fence orders those reads before the copies' writes.
  auto issue_feats = [&](int u, int buf, unsigned live) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned bar = full0 + 8 * buf;
    mbar_expect_tx(bar, __popc(live) * WALK_TMA_KSTEP_BYTES);
    const unsigned dst = smem_u32(fs) + buf * KS * WALK_TMA_KSTEP_BYTES;
    const int row0 = (b * ng_total + ng) * Mp;
    int first[SUB];   // the rows of the iteration's list entries
#pragma unroll
    for (int e = 0; e < SUB; ++e)
      first[e] = (live >> (e * (TILE / 16))) & ((1u << (TILE / 16)) - 1u)
                     ? row0 + tile_of(u * SUB + e) * TILE : 0;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if (!((live >> s) & 1u)) continue;
      const int row = first[s / (TILE / 16)] + (s % (TILE / 16)) * 16;
      tma_load_2d(dst + s * WALK_TMA_KSTEP_BYTES, fmap, bar, 0, row);
      tma_load_2d(dst + s * WALK_TMA_KSTEP_BYTES + WALK_TMA_KSTEP_BYTES / 2, fmap, bar,
                  TMA_BOX_K, row);
    }
  };
  // The codes of the 16 x ROWS block of iteration u (coordinates in
  // cxyz[buf]) into codes[buf], in each lane's fragment order: code (m, j)
  // at byte ((j/16)*32 + (m%8)*4 + (j%8)/2)*8 + ((j/8)%2)*4 + (m/8)*2 + j%2
  // (k-step, lane, position in the lane's 8 bytes); and each warp's live
  // k-steps of the CTA's cells into live_w[buf][warp].  Thread t takes
  // center t % 16 (kept in registers) and candidates t/16, t/16 + step, ...
  auto make_codes = [&](int u, int buf) {
    const float* cx = cxyz + buf * ROWS * 3;
    unsigned char* cb = reinterpret_cast<unsigned char*>(codes + buf * KS * 32);
    const int n_real = min(n_walk - u * SUB, SUB) * TILE;
    const int m = threadIdx.x & 15;
    const float px = pc[m * 3 + 0], py = pc[m * 3 + 1], pz = pc[m * 3 + 2];
    unsigned char* cm = cb + (m & 7) * 32 + (m >> 3) * 2;
    unsigned live = 0;
#pragma unroll 4
    for (int j = threadIdx.x >> 4; j < ROWS; j += nthreads >> 4) {
      // pair_code(candidate, center): the column is the candidate, or for
      // dX the row
      const int code = j >= n_real ? N_CELLS
                       : DX ? pair_code(px, py, pz, cx[j * 3 + 0], cx[j * 3 + 1],
                                        cx[j * 3 + 2], r2, radius, inv)
                            : pair_code(cx[j * 3 + 0], cx[j * 3 + 1], cx[j * 3 + 2],
                                        px, py, pz, r2, radius, inv);
      cm[(j >> 4) * 256 + ((j & 6) << 2) + ((j & 8) >> 1) + (j & 1)] =
          (unsigned char)(code >= 0 && code < N_CELLS ? code : NO_CELL);
      if (code >= cell_lo && code < cell_hi) live |= 1u << (j >> 4);
    }
    live = __reduce_or_sync(0xffffffffu, live);
    if (lane == 0) live_w[buf * 32 + warp] = (unsigned char)live;
  };
  auto live_of = [&](int buf) {   // TMA: one warp's byte a lane, ORed over the warp
    if constexpr (TMA) {
      return __reduce_or_sync(0xffffffffu, lane < nwarps ? live_w[buf * 32 + lane] : 0u);
    } else {
      unsigned live = 0;
      for (int w = 0; w < nwarps; ++w) live |= live_w[buf * 32 + w];
      return live;
    }
  };

  float acc[CW][NT][4];
#pragma unroll
  for (int i = 0; i < CW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  // TMA: ac += a . (k-step s of buffer buf), NT = 16 n8-tiles; lane l
  // reads row l % 16 of the k-step, 16-byte chunk c = 2p + l / 16 of its
  // 256-byte row (half c / 8, position c % 8 XOR the row % 8: the 128-byte
  // swizzle TMA wrote)
  auto mma_tma = [&](float (&ac)[NT][4], const unsigned (&a)[4], int buf, int s) {
    const int r = lane & 15;
    const unsigned row = smem_u32(fs) + (buf * KS + s) * WALK_TMA_KSTEP_BYTES + r * 128;
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const int c = 2 * p + (lane >> 4);
      unsigned bb[4];
      ldsm_x4_t(bb, row + (c >> 3) * (WALK_TMA_KSTEP_BYTES / 2) + (((c & 7) ^ (r & 7)) << 4));
      mma_bf16(ac[2 * p], a, bb[0], bb[1]);
      mma_bf16(ac[2 * p + 1], a, bb[2], bb[3]);
    }
  };
  // ac += a . (the staged rows at frow, every term), NT n8-tiles
  auto mma_terms = [&](float (&ac)[NT][4], const unsigned (&a)[4],
                       const __nv_bfloat16* frow) {
#pragma unroll
    for (int term = 0; term < TERMS; ++term) {
      const __nv_bfloat16* fp = frow + term * ROWS * SP;
      if constexpr (NT == 1) {
        unsigned b0, b1;
        ldsm_x2_t(b0, b1, fp);
        mma_bf16(ac[0], a, b0, b1);
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          unsigned bb[4];
          ldsm_x4_t(bb, fp + p * 16);
          mma_bf16(ac[2 * p], a, bb[0], bb[1]);
          mma_bf16(ac[2 * p + 1], a, bb[2], bb[3]);
        }
      }
    }
  };

  // The codes run one iteration ahead of the sums, so that each
  // iteration's features are fetched for its live k-steps only and land
  // while the iteration before is summed.
  unsigned live_cur = 0;
  if (n_it > 0) {
    stage_xyz(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    PW_SPLIT(PART_WAIT)
    make_codes(0, 0);
    PW_SPLIT(PART_CODES)
    __syncthreads();
    PW_SPLIT(PART_WAIT)
    live_cur = live_of(0);
    if constexpr (TMA) {
      if (threadIdx.x == 0) issue_feats(0, 0, live_cur);
    } else {
      stage_feats(0, 0, live_cur);
    }
    if (n_it > 1) stage_xyz(1, 1);
    cp_async_commit();
    PW_SPLIT(PART_STAGE)
  }
  for (int u = 0; u < n_it; ++u) {
    const int buf = u & 1;
    cp_async_wait_all();
    __syncthreads();   // u's features and u+1's coordinates landed; u-1 summed
    PW_SPLIT(PART_WAIT)
    if (u + 1 < n_it) make_codes(u + 1, buf ^ 1);
    PW_SPLIT(PART_CODES)
    __syncthreads();   // u+1's codes and live k-steps written
    PW_SPLIT(PART_WAIT)
    unsigned live_next = 0;
    if (u + 1 < n_it) {
      live_next = live_of(buf ^ 1);
      if constexpr (TMA) {
        if (threadIdx.x == 0) issue_feats(u + 1, buf ^ 1, live_next);
      } else {
        stage_feats(u + 1, buf ^ 1, live_next);
      }
      if (u + 2 < n_it) stage_xyz(u + 2, buf);
    }
    cp_async_commit();
    PW_SPLIT(PART_STAGE)
    if constexpr (TMA) {
      mbar_wait(full0 + 8 * buf, (u >> 1) & 1);   // u's features landed
      PW_SPLIT(PART_WAIT)
    }

    if (active && live_cur != 0u) {
      const __nv_bfloat16* ft = fs + buf * TERMS * ROWS * SP;
      const __nv_bfloat16* st = ss + buf * STERMS * N_CELLS * ROWS;
      const uint2* cbuf = codes + buf * KS * 32;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (!((live_cur >> s) & 1u)) continue;   // no pair of the CTA's cells
        const uint2 cw = cbuf[s * 32 + lane];
        const __nv_bfloat16* frow = ft + (s * 16 + (lane & 15)) * SP + (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          const int k = cg * CW + i;
          const unsigned kk = (unsigned)k * 0x01010101u;
          const unsigned e0 = __vcmpeq4(cw.x, kk);
          const unsigned e1 = __vcmpeq4(cw.y, kk);
          if (!__any_sync(0xffffffffu, (e0 | e1) != 0u)) {   // empty cell
            PW_SPLIT(PART_TESTS)
            continue;
          }
          // the plane's masks: rows g and g+8, columns 2tq, 2tq+1 (m0, m1)
          // and 2tq+8, 2tq+9 (m2, m3), as bf16 pairs
          const unsigned m0 = __byte_perm(e0, 0u, 0x1100), m1 = __byte_perm(e0, 0u, 0x3322);
          const unsigned m2 = __byte_perm(e1, 0u, 0x1100), m3 = __byte_perm(e1, 0u, 0x3322);
          PW_SPLIT(PART_TESTS)
          if constexpr (DX) {
            // the scaled plane: each column's scale in place of the ones
#pragma unroll
            for (int term = 0; term < STERMS; ++term) {
              const unsigned* sw = reinterpret_cast<const unsigned*>(
                  st + (term * N_CELLS + k - cell_lo) * ROWS + s * 16);
              const unsigned s01 = sw[lane & 3], s89 = sw[(lane & 3) + 4];
              const unsigned a[4] = {m0 & s01, m1 & s01, m2 & s89, m3 & s89};
              mma_terms(acc[i], a, frow);
            }
          } else {
            const unsigned a[4] = {m0 & ONE2, m1 & ONE2, m2 & ONE2, m3 & ONE2};
            if constexpr (TMA)
              mma_tma(acc[i], a, buf, s);
            else
              mma_terms(acc[i], a, frow);
          }
          PW_SPLIT(PART_MMA)
        }
      }
    }
    live_cur = live_next;
  }
  if (!active) {
    PW_SPLIT_END
    return;
  }

  // means (and counts), or dX's sums: thread (g, tq) holds rows g and
  // g+8, columns nt*8 + 2*tq + {0, 1}; the count is column W8-1, held by
  // lane g*4 + 3
  const int g = lane >> 2, tq = lane & 3;
  const int per = W8 - 1;
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const int k = cg * CW + i;
    if (k >= N_CELLS) continue;   // warp-uniform
    float own[2] = {0.f, 0.f};
    if constexpr (!DX) {
      own[0] = __shfl_sync(0xffffffffu, acc[i][NT - 1][1], (lane & ~3) | 3);
      own[1] = __shfl_sync(0xffffffffu, acc[i][NT - 1][3], (lane & ~3) | 3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t rg = (size_t)b * Ncp + c0 + g + 8 * h;
      float d = 1.f;
      if constexpr (!DX) {
        if (cnt_out != nullptr && ng == 0 && tq == 3) cnt_out[rg * N_CELLS + k] = own[h];
        d = fmaxf(cnt_in != nullptr ? cnt_in[rg * N_CELLS + k] : own[h], 1.f);
      }
      T* xr = xbar + rg * ldx + (size_t)k * cin;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lc = n * 8 + 2 * tq + e;
          const int ch = ng * per + lc;
          if (lc < per && ch < cin) {
            const float v = acc[i][n][2 * h + e];
            xr[ch] = from_f32<T>(DX ? v : v / d);
          }
        }
      }
    }
  }
  PW_SPLIT(PART_EPILOGUE)
  PW_SPLIT_END
}

template <typename Tag, typename T, int NT>
int launch_walk_nt(const WalkShape& s, const float* ctr, const float* pts,
                   const __nv_bfloat16* packed, const __nv_bfloat16* scl, const int* tile_ptr,
                   const int* tile_idx, const float* cnt_in, float* cnt_out, T* xbar, int ldx,
                   int B, int Ncp, int Mp, int cin, float radius, float inv,
                   cudaStream_t stream) {
  const size_t smem = walk_smem_bytes<Tag, T>(cin);
  CUtensorMap tf;
  memset(&tf, 0, sizeof tf);
  if (walk_tma<Tag, T>(NT)) {   // packed {NT*8 = 128 columns, terms*B*ng*Mp rows}
    const int e = encode_map(&tf, packed, NT * 8, Terms<T>::value * B * s.ng * Mp, NT * 8, 16);
    if (e != 0) return -e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      pw_walk_kernel<Tag, T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Ncp / WALK_M) * s.ng * s.ctas, B);
  pw_walk_kernel<Tag, T, NT><<<grid, s.warps * 32, smem, stream>>>(
      ctr, pts, packed, scl, tile_ptr, tile_idx, cnt_in, cnt_out, xbar, ldx, B, Ncp, Mp, cin,
      s.ng, s.ctas, radius, inv, tf);
  return (int)cudaGetLastError();
}

inline int grid_blocks(size_t n) {
  return (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
}

// Pack the features (dX: round g and write the scales), then walk.
// packed holds walk_pack_elems<T> bf16; for DxSums, feats is g (f32),
// cnt_in the counts the scales come from and scl walk_scale_elems<T>(B, Mp)
// bf16 of scratch.  Returns the first cudaError_t (0 = launched).
template <typename Tag, typename T>
int launch_walk(const float* ctr, const float* pts, const void* feats,
                __nv_bfloat16* packed, __nv_bfloat16* scl, const int* tile_ptr,
                const int* tile_idx, const float* cnt_in, float* cnt_out, T* xbar, int ldx,
                int B, int Ncp, int Mp, int cin, float radius, float inv,
                cudaStream_t stream) {
  constexpr bool DX = IsDx<Tag>::value;
  using Tin = typename std::conditional<DX, float, T>::type;
  if (cin < 1 || cin > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  const WalkShape s = walk_shape(cin);
  const size_t n = (size_t)B * s.ng * Mp * s.nt * 8;
  pw_walk_pack_kernel<Tag, T, Tin><<<grid_blocks(n), 256, 0, stream>>>(
      static_cast<const Tin*>(feats), packed, B, Mp, cin, s.nt, s.ng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (DX) {
    pw_walk_scale_kernel<Tag, T><<<grid_blocks((size_t)B * Mp * N_CELLS), 256, 0, stream>>>(
        cnt_in, scl, B, Mp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cnt_in = nullptr;
  }
  switch (s.nt) {
    case 1:
      return launch_walk_nt<Tag, T, 1>(s, ctr, pts, packed, scl, tile_ptr, tile_idx, cnt_in,
                                       cnt_out, xbar, ldx, B, Ncp, Mp, cin, radius, inv, stream);
    case 2:
      return launch_walk_nt<Tag, T, 2>(s, ctr, pts, packed, scl, tile_ptr, tile_idx, cnt_in,
                                       cnt_out, xbar, ldx, B, Ncp, Mp, cin, radius, inv, stream);
    case 4:
      return launch_walk_nt<Tag, T, 4>(s, ctr, pts, packed, scl, tile_ptr, tile_idx, cnt_in,
                                       cnt_out, xbar, ldx, B, Ncp, Mp, cin, radius, inv, stream);
    case 8:
      return launch_walk_nt<Tag, T, 8>(s, ctr, pts, packed, scl, tile_ptr, tile_idx, cnt_in,
                                       cnt_out, xbar, ldx, B, Ncp, Mp, cin, radius, inv, stream);
    default:
      return launch_walk_nt<Tag, T, 16>(s, ctr, pts, packed, scl, tile_ptr, tile_idx, cnt_in,
                                        cnt_out, xbar, ldx, B, Ncp, Mp, cin, radius, inv, stream);
  }
}

}  // namespace pw
