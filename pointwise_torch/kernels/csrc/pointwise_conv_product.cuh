// pointwise_conv_product.cuh — the (rows x K) x (K x N) product that the
// forward (pointwise_conv_fwd.cu), the feature gradient
// (pointwise_conv_dx.cu) and the weight gradient (pointwise_conv_dw.cu) end
// with: _finalize_tile's product (:297), _dx_finalize's (:476) and
// _dw_finalize's (:434) of pointwise_tpu/kernels/pointwise_conv_pallas.py.
//
//   forward  y  = xbar . W + bias,    xbar (rows, 27*Cin),  W (27*Cin, Cout)
//   dX       dx = round(Z) . W^T,     Z (rows, 27*Cout),    W^T (27*Cout, Cin)
//   dW       dW = xbar^T . round(g),  xbar^T (27*Cin, rows), g (rows, Cout)
//
// dW's design (its A M-major, its split over the centers, the reduce) is
// in pointwise_conv_dw.cu's note; below, the forward's and dX's.
//
// What bounds it on an H100: the A operand (27*Cin or 27*Cout bf16 per row)
// read once from device memory.  Its 2*K*N flops per row need about 40% of
// that time on the tensor cores at N = 124, so the copies and the MMAs must
// overlap, and enough bytes must be in flight on every SM.
//
// bf16 (pw_product_kernel), built on Hopper's own machinery:
//   - TMA.  Two 2-D tensor maps, encoded per call by the host: A {K, rows}
//     with the caller's row stride, W as B^T {K, N} (K-major, so wgmma
//     reads both operands without the transpose bit).  Boxes of 64 columns
//     (128 bytes, SWIZZLE_128B) by the tile's rows or N.  The hardware
//     fills reads past K (the workspace's garbage columns are never read)
//     and past the last row or column with zeros.
//   - A ring of STAGES shared-memory stages (4-6, under 227 KB), one
//     full/empty mbarrier pair each.  One producer thread issues every TMA
//     and keeps the ring full across tiles; the full barrier completes on
//     the stage's bytes.
//   - Two consumer warpgroups run wgmma.mma_async m64 N k16 (bf16 in, f32
//     accumulate) on each stage that arrived and release it through its
//     empty barrier (one arrival per consumer warp).  setmaxnreg moves
//     registers from the producer's warpgroup (40) to the consumers (232).
//   - Tiles: N = the smallest of 8..256 (powers of two) that holds n, or
//     256 in ceil(n / 256) tiles; BM = 256 rows (two m64 sub-tiles per
//     consumer) for N <= 128, 128 rows for N = 256.  W is read from L2 once
//     per BM rows (the tall tile quarters what a 64-row tile read: 0.74
//     against 3.07 GB at the forward's 229,376 x 3,348 x 124).  No cluster
//     yet: a pair multicasting W would halve that again (not tried).
//   - A persistent grid, one CTA per SM (the caller passes min(tiles,
//     SMs)), walks the tiles in order t = blockIdx.x, + gridDim.x, ...;
//     the producer loads the next tile while the consumers store this one.
//   - The epilogue adds the bias in f32 after the sum and stores f32 with
//     plain stores masked to rows and n (y's row stride, n*4 bytes, is not
//     always a multiple of 16).
// f32 (the exactness checks, off the serving and training paths):
// pw_product_f32_kernel, f32 FMAs on the CUDA cores in ascending k, a 64 x
// 64 output tile per CTA.
//
// Every output element has one owner thread and one summation order: k in
// steps of 64, each as four k16 MMAs in ascending k, into an accumulator
// zeroed at the tile's start.  For the forward and dX no split-K, no
// atomics, and nothing depends on rows, a row's position or the SM count
// (the tile shape depends on n only), so the result repeats bit for bit
// and a row shard's product equals the same rows of the whole product.
// The tag (FwdProduct, DxProduct, DwProduct) names the kernel, so traces
// tell the three products apart.

#pragma once

#include "pointwise_conv_walk.cuh"

namespace pw {

struct FwdProduct {};
struct DxProduct {};
struct DwProduct {};   // dW = xbar^T . round(g): A M-major, split over the centers

// A in memory with its rows (M) contiguous, read with wgmma's transpose bit.
template <typename Tag>
struct AMajorMN { static constexpr bool value = false; };
template <>
struct AMajorMN<DwProduct> { static constexpr bool value = true; };

constexpr int PROD_M = 64;      // rows per f32 product CTA (and the row unit)
constexpr int PROD_K = 32;      // k-step of the f32 kernel
constexpr int PROD_THREADS = 256;
constexpr int PROD_F32_N = 64;  // columns per f32 product CTA

constexpr int GEMM_BK = TMA_BOX_K;   // k-step: 64 bf16, one 128-byte swizzle row
constexpr int GEMM_CONSUMERS = 2;    // consumer warpgroups
constexpr int GEMM_THREADS = 128 * (GEMM_CONSUMERS + 1);
constexpr int GEMM_RING_BYTES = 230400;   // stages' budget under 227 KB
constexpr int GEMM_MAX_STAGES = 8;
constexpr int GEMM_BOX_BYTES = 64 * GEMM_BK * 2;   // 64 rows by one k-step

// The tile of an N tile BN (8, 16, ..., 256): rows, stages, shared memory.
template <int BN>
struct GemmTile {
  static constexpr int MT = BN <= 128 ? 2 : 1;          // m64 sub-tiles per consumer
  static constexpr int BM = 64 * MT * GEMM_CONSUMERS;   // rows per tile
  static constexpr int A_BYTES = BM * GEMM_BK * 2;
  static constexpr int B_BYTES = BN * GEMM_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = GEMM_RING_BYTES / STAGE_BYTES < GEMM_MAX_STAGES
                                    ? GEMM_RING_BYTES / STAGE_BYTES : GEMM_MAX_STAGES;
  // 1024 to align the ring to the swizzle atom, then the ring and barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// ---- wgmma (PTX; the mbarrier and TMA helpers: pointwise_conv_common.cuh) ----

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 64 bf16, 8-row atoms of 1024 bytes): start address >> 4, leading
// offset 1 (unused by this layout), stride 1024 bytes >> 4, layout 1.  A
// k16 slice starts 32 bytes further; the atom's base stays 1024-aligned.
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}
// The same for an M-major tile (rows contiguous: each 128-byte line holds 64
// rows of one k, 8 lines per 1024-byte atom), read with the transpose bit:
// the stride between 8-k groups is 1024 bytes; the offset between 64-row
// groups is unused, since every wgmma reads 64 rows (it is set to the same
// 1024).  A k16 slice starts 16 lines (2048 bytes) further.
__device__ __forceinline__ uint64_t gmma_desc_mn(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous MMAs.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, in registers) += A (64 x 16) . B (16 x N), both bf16 in
// shared memory through descriptors; B K-major, A K-major (TA = 0) or
// M-major (TA = 1, the transpose bit).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TA>
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <>
struct Wgmma<16> {
  template <int TA>
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <>
struct Wgmma<32> {
  template <int TA>
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <>
struct Wgmma<64> {
  template <int TA>
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <>
struct Wgmma<128> {
  template <int TA>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <>
struct Wgmma<256> {
  template <int TA>
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

// ---- the bf16 product --------------------------------------------------

// y (rows, n) f32 = A . B (+ bias), A (rows x K) and B (K x n) bf16.
//   FwdProduct, DxProduct: tma_a over a {K, rows} (K-major, one box of 64 k
//     by BM rows a stage), all of K in one slice (kchunk = the k-steps).
//   DwProduct: A = xbar^T, tma_a over xbar {rows, K} (M-major: rows are
//     contiguous; BM/64 boxes of 64 rows by 64 k a stage, read with wgmma's
//     transpose bit); slice sl of the k-steps (sl*kchunk .. +kchunk) writes
//     its partial sums to y + sl*rows*n.
// tma_b over B^T {K, n} (K-major), boxes of 64 k by BN; 128-byte swizzle
// throughout; bias (n,) f32 or null.  Work units: (tile, slice), the tile
// fastest; grid <= units, one CTA per SM.
template <typename Tag, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
pw_product_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b, const float* __restrict__ bias,
                  float* __restrict__ y, int rows, int K, int n, int kchunk) {
  using T = GemmTile<BN>;
  constexpr bool MN = AMajorMN<Tag>::value;
  extern __shared__ unsigned char smem_raw[];
  const unsigned ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned a_ring = ring, b_ring = ring + T::STAGES * T::A_BYTES;
  const unsigned full0 = ring + T::STAGES * T::STAGE_BYTES, empty0 = full0 + 8 * T::STAGES;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = ((rows + T::BM - 1) / T::BM) * n_tiles;
  const int ksteps = (K + GEMM_BK - 1) / GEMM_BK;
  const int units = tiles * ((ksteps + kchunk - 1) / kchunk);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                      // the producer's expect_tx
      mbar_init(empty0 + 8 * s, GEMM_CONSUMERS * 4);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == GEMM_CONSUMERS) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == GEMM_CONSUMERS * 128) {
      tma_prefetch(&tma_a);
      tma_prefetch(&tma_b);
      int s = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < units; t += gridDim.x) {
        const int tile = t % tiles, sl = t / tiles;
        const int r0 = (tile / n_tiles) * T::BM, c0 = (tile % n_tiles) * BN;
        const int kend = min((sl + 1) * kchunk, ksteps);
        // M-major A: a box that starts past the last row holds no row of y
        // and is not loaded (its shared memory feeds only rows never stored)
        const int boxes = MN ? min(T::BM / 64, (rows - r0 + 63) / 64) : 1;
        const unsigned bytes = MN ? boxes * GEMM_BOX_BYTES + T::B_BYTES : T::STAGE_BYTES;
        for (int kt = sl * kchunk; kt < kend; ++kt) {
          mbar_wait(empty0 + 8 * s, phase ^ 1);         // the consumers released it
          mbar_expect_tx(full0 + 8 * s, bytes);
          const unsigned a_s = a_ring + s * T::A_BYTES;
          if constexpr (MN) {
            for (int j = 0; j < boxes; ++j)
              tma_load_2d(a_s + j * GEMM_BOX_BYTES, &tma_a, full0 + 8 * s, r0 + 64 * j,
                          kt * GEMM_BK);
          } else {
            tma_load_2d(a_s, &tma_a, full0 + 8 * s, kt * GEMM_BK, r0);
          }
          tma_load_2d(b_ring + s * T::B_BYTES, &tma_b, full0 + 8 * s, kt * GEMM_BK, c0);
          if (++s == T::STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows wg * MT * 64 .. of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float d[T::MT][BN / 2];
    int s = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < units; t += gridDim.x) {
      const int tile = t % tiles, sl = t / tiles;
      const int r0 = (tile / n_tiles) * T::BM, c0 = (tile % n_tiles) * BN;
      const int kend = min((sl + 1) * kchunk, ksteps);
#pragma unroll
      for (int q = 0; q < T::MT; ++q)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[q][i] = 0.f;
      for (int kt = sl * kchunk; kt < kend; ++kt) {
        mbar_wait(full0 + 8 * s, phase);
        // sub-tile q's 64 rows: 64 rows x 128 bytes of a K-major tile, or
        // one 64 x 64 box of the M-major one
        const unsigned a_s = a_ring + s * T::A_BYTES + wg * T::MT * GEMM_BOX_BYTES;
        const unsigned b_s = b_ring + s * T::B_BYTES;
#pragma unroll
        for (int q = 0; q < T::MT; ++q) fence_acc(d[q]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk)
#pragma unroll
          for (int q = 0; q < T::MT; ++q) {
            const unsigned a_q = a_s + q * GEMM_BOX_BYTES;
            if constexpr (MN)   // k16 = 16 rows of 128 bytes further
              Wgmma<BN>::template mma<1>(d[q], gmma_desc_mn(a_q + kk * 2048),
                                         gmma_desc(b_s + kk * 32));
            else                // k16 = 32 bytes further in each row
              Wgmma<BN>::template mma<0>(d[q], gmma_desc(a_q + kk * 32),
                                         gmma_desc(b_s + kk * 32));
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int q = 0; q < T::MT; ++q) fence_acc(d[q]);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);     // this warp is done with stage s
        if (++s == T::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      // D fragment: warp w holds rows 16w + lane/4 (+8), columns 8i +
      // 2*(lane%4) (+1) of each m64 sub-tile
      float* ys = y + (size_t)sl * rows * n;
#pragma unroll
      for (int q = 0; q < T::MT; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + (wg * T::MT + q) * 64 + warp * 16 + (lane >> 2) + 8 * h;
          if (r >= rows) continue;
          float* yr = ys + (size_t)r * n;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int c = c0 + i * 8 + 2 * (lane & 3);
            float v0 = d[q][4 * i + 2 * h], v1 = d[q][4 * i + 2 * h + 1];
            if (bias != nullptr) {
              if (c < n) v0 += bias[c];
              if (c + 1 < n) v1 += bias[c + 1];
            }
            if (c + 1 < n && (n & 1) == 0) {
              *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
            } else {
              if (c < n) yr[c] = v0;
              if (c + 1 < n) yr[c + 1] = v1;
            }
          }
        }
      }
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

// The N tile of an n-column product: the smallest power of two from 8 to
// 256 that holds n, else 256 (ceil(n / 256) tiles).
inline int gemm_bn(int n) {
  int bn = 8;
  while (bn < n && bn < 256) bn *= 2;
  return bn;
}

// Both tensor maps of a product: a (rows, lda) K-major, or M-major (mn:
// xbar (K, lda), whose rows are the k index), boxes of GemmTile<bn>'s
// rows; wt = B^T (n, ldw).  Returns 0, or minus the CUresult of a failed
// encode.
inline int encode_product_maps(CUtensorMap* ta, CUtensorMap* tb, bool mn, const void* a,
                               int lda, const void* wt, int ldw, int rows, int K, int n) {
  const int bn = gemm_bn(n), bm = bn <= 128 ? 256 : 128;   // GemmTile<bn>::BM
  int err = mn ? encode_map(ta, a, rows, K, lda, 64) : encode_map(ta, a, K, rows, lda, bm);
  if (err == 0) err = encode_map(tb, wt, K, n, ldw, bn);
  return -err;
}

template <typename Tag, int BN>
int launch_gemm(const void* a, int lda, const void* wt, int ldw, const float* bias, float* y,
                int rows, int K, int n, int kchunk, int bm, int stages, int grid,
                cudaStream_t stream) {
  using T = GemmTile<BN>;
  if (bm != T::BM || stages != T::STAGES) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const int err =
      encode_product_maps(&ta, &tb, AMajorMN<Tag>::value, a, lda, wt, ldw, rows, K, n);
  if (err != 0) return err;
  auto kernel = pw_product_kernel<Tag, BN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, GEMM_THREADS, T::SMEM, stream>>>(ta, tb, bias, y, rows, K, n, kchunk);
  return (int)cudaGetLastError();
}

// launch_gemm at the N tile bn (= gemm_bn(n), checked): 1 <= grid, kchunk
// the k-steps of a slice.
template <typename Tag>
int dispatch_gemm(const void* a, int lda, const void* wt, int ldw, const float* bias, float* y,
                  int rows, int K, int n, int kchunk, int bn, int bm, int stages, int grid,
                  cudaStream_t stream) {
  if (grid < 1 || kchunk < 1 || bn != gemm_bn(n)) return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 8: return launch_gemm<Tag, 8>(
        a, lda, wt, ldw, bias, y, rows, K, n, kchunk, bm, stages, grid, stream);
    case 16: return launch_gemm<Tag, 16>(
        a, lda, wt, ldw, bias, y, rows, K, n, kchunk, bm, stages, grid, stream);
    case 32: return launch_gemm<Tag, 32>(
        a, lda, wt, ldw, bias, y, rows, K, n, kchunk, bm, stages, grid, stream);
    case 64: return launch_gemm<Tag, 64>(
        a, lda, wt, ldw, bias, y, rows, K, n, kchunk, bm, stages, grid, stream);
    case 128: return launch_gemm<Tag, 128>(
        a, lda, wt, ldw, bias, y, rows, K, n, kchunk, bm, stages, grid, stream);
    default: return launch_gemm<Tag, 256>(
        a, lda, wt, ldw, bias, y, rows, K, n, kchunk, bm, stages, grid, stream);
  }
}

// y (rows, n) f32 = a (rows, lda; K columns read) . w (+ bias).  rows a
// multiple of 64, at least one.  bf16 != 0: a bf16 at a 16-byte aligned
// address, lda a multiple of 8; w = W^T (n, ldw) bf16, K-major, ldw a
// multiple of 8 (columns past K never read); bn = gemm_bn(n), bm and
// stages the caller's plan of that tile (it must match GemmTile<bn>, so
// the plan the wrapper reports is the kernel's), 1 <= grid <= the tiles
// (the persistent grid).  Else f32: w (K, n), the plan unused.  Returns
// the cudaError_t of the launch (0 = launched), or minus the CUresult of a
// failed tensor-map encode.
template <typename Tag>
int launch_product(const void* a, int lda, const void* w, int ldw, const float* bias, float* y,
                   int rows, int K, int n, int bf16, int bn, int bm, int stages, int grid,
                   cudaStream_t stream) {
  if (!bf16) {
    dim3 g(rows / PROD_M, (n + PROD_F32_N - 1) / PROD_F32_N);
    pw_product_f32_kernel<Tag><<<g, PROD_THREADS, 0, stream>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(w), bias, y, K, n);
    return (int)cudaGetLastError();
  }
  return dispatch_gemm<Tag>(a, lda, w, ldw, bias, y, rows, K, n, (K + GEMM_BK - 1) / GEMM_BK,
                            bn, bm, stages, grid, stream);
}

}  // namespace pw
