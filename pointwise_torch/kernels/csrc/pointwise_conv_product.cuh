// pointwise_conv_product.cuh — the (rows x K) x (K x N) product that the
// forward (pointwise_conv_fwd.cu) and the feature gradient
// (pointwise_conv_dx.cu) end with: _finalize_tile's product (:297) and
// _dx_finalize's (:476) of pointwise_tpu/kernels/pointwise_conv_pallas.py.
//
//   forward  y  = xbar . W + bias,    xbar (rows, 27*Cin),  W (27*Cin, Cout)
//   dX       dx = round(Z) . W^T,     Z (rows, 27*Cout),    W^T (27*Cout, Cin)
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
// zeroed at the tile's start.  No split-K, no atomics, and nothing depends
// on rows, a row's position or the SM count (the tile shape depends on n
// only), so the result repeats bit for bit and a row shard's product
// equals the same rows of the whole product.  The tag (FwdProduct,
// DxProduct) names the kernel, so traces tell the forward's product from
// dX's.

#pragma once

#include <cuda.h>   // CUtensorMap, cuTensorMapEncodeTiled (linked with -lcuda)
#include <stdint.h>

#include "pointwise_conv_walk.cuh"

namespace pw {

struct FwdProduct {};
struct DxProduct {};

constexpr int PROD_M = 64;      // rows per f32 product CTA (and the row unit)
constexpr int PROD_K = 32;      // k-step of the f32 kernel
constexpr int PROD_THREADS = 256;
constexpr int PROD_F32_N = 64;  // columns per f32 product CTA

constexpr int GEMM_BK = 64;          // k-step: 64 bf16, one 128-byte swizzle row
constexpr int GEMM_CONSUMERS = 2;    // consumer warpgroups
constexpr int GEMM_THREADS = 128 * (GEMM_CONSUMERS + 1);
constexpr int GEMM_RING_BYTES = 230400;   // stages' budget under 227 KB
constexpr int GEMM_MAX_STAGES = 8;

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

// ---- mbarrier, TMA and wgmma (PTX) ----------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity ``parity`` of the barrier has completed.
// A stage arrives within microseconds; a wait of 2^36 cycles (~35 s) can
// only be a fault, and traps, so a broken ring fails its launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 36)) __trap();
  }
}
// A 2-D box of the tensor map at (c0 innermost, c1) into shared memory,
// completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 64 bf16, 8-row atoms of 1024 bytes): start address >> 4, leading
// offset 1 (unused by this layout), stride 1024 bytes >> 4, layout 1.  A
// k16 slice starts 32 bytes further; the atom's base stays 1024-aligned.
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
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
// shared memory through descriptors, both K-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
  }
};

// ---- the bf16 product --------------------------------------------------

// y (rows, n) f32 = a . w (+ bias): tma_a over a {K, rows}, tma_b over w^T
// {K, n} (K-major), both bf16 with 128-byte swizzled boxes of 64 columns;
// bias (n,) f32 or null.  grid <= tiles, one CTA per SM.
template <typename Tag, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
pw_product_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b, const float* __restrict__ bias,
                  float* __restrict__ y, int rows, int K, int n) {
  using T = GemmTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned a_ring = ring, b_ring = ring + T::STAGES * T::A_BYTES;
  const unsigned full0 = ring + T::STAGES * T::STAGE_BYTES, empty0 = full0 + 8 * T::STAGES;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = ((rows + T::BM - 1) / T::BM) * n_tiles;
  const int ksteps = (K + GEMM_BK - 1) / GEMM_BK;
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
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r0 = (t / n_tiles) * T::BM, c0 = (t % n_tiles) * BN;
        for (int kt = 0; kt < ksteps; ++kt) {
          mbar_wait(empty0 + 8 * s, phase ^ 1);         // the consumers released it
          mbar_expect_tx(full0 + 8 * s, T::STAGE_BYTES);
          tma_load_2d(a_ring + s * T::A_BYTES, &tma_a, full0 + 8 * s, kt * GEMM_BK, r0);
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
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r0 = (t / n_tiles) * T::BM, c0 = (t % n_tiles) * BN;
#pragma unroll
      for (int m = 0; m < T::MT; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[m][i] = 0.f;
      for (int kt = 0; kt < ksteps; ++kt) {
        mbar_wait(full0 + 8 * s, phase);
        const unsigned a_s = a_ring + s * T::A_BYTES + wg * T::MT * 64 * 128;
        const unsigned b_s = b_ring + s * T::B_BYTES;
#pragma unroll
        for (int m = 0; m < T::MT; ++m) fence_acc(d[m]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk)
#pragma unroll
          for (int m = 0; m < T::MT; ++m)
            Wgmma<BN>::mma(d[m], gmma_desc(a_s + m * 64 * 128 + kk * 32),
                           gmma_desc(b_s + kk * 32));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int m = 0; m < T::MT; ++m) fence_acc(d[m]);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);     // this warp is done with stage s
        if (++s == T::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      // D fragment: warp w holds rows 16w + lane/4 (+8), columns 8i +
      // 2*(lane%4) (+1) of each m64 sub-tile
#pragma unroll
      for (int m = 0; m < T::MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + (wg * T::MT + m) * 64 + warp * 16 + (lane >> 2) + 8 * h;
          if (r >= rows) continue;
          float* yr = y + (size_t)r * n;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int c = c0 + i * 8 + 2 * (lane & 3);
            float v0 = d[m][4 * i + 2 * h], v1 = d[m][4 * i + 2 * h + 1];
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

// A 2-D bf16 tensor map over (outer, inner) with row stride ld elements
// (a multiple of 8), boxes of GEMM_BK x box_outer, 128-byte swizzle, zeros
// past the edges.  Returns the CUresult (0 = encoded).
inline int encode_map(CUtensorMap* map, const void* base, int inner, int outer, int ld,
                      int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)GEMM_BK, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return (int)cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     const_cast<void*>(base), dims, strides, box, elem,
                                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename Tag, int BN>
int launch_gemm(const void* a, int lda, const void* wt, int ldw, const float* bias, float* y,
                int rows, int K, int n, int bm, int stages, int grid, cudaStream_t stream) {
  using T = GemmTile<BN>;
  if (bm != T::BM || stages != T::STAGES) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = encode_map(&ta, a, K, rows, lda, T::BM);
  if (err == 0) err = encode_map(&tb, wt, K, n, ldw, BN);
  if (err != 0) return -err;   // a failed encode: minus its CUresult
  auto kernel = pw_product_kernel<Tag, BN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, GEMM_THREADS, T::SMEM, stream>>>(ta, tb, bias, y, rows, K, n);
  return (int)cudaGetLastError();
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
  if (grid < 1 || bn != gemm_bn(n)) return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 8: return launch_gemm<Tag, 8>(
        a, lda, w, ldw, bias, y, rows, K, n, bm, stages, grid, stream);
    case 16: return launch_gemm<Tag, 16>(
        a, lda, w, ldw, bias, y, rows, K, n, bm, stages, grid, stream);
    case 32: return launch_gemm<Tag, 32>(
        a, lda, w, ldw, bias, y, rows, K, n, bm, stages, grid, stream);
    case 64: return launch_gemm<Tag, 64>(
        a, lda, w, ldw, bias, y, rows, K, n, bm, stages, grid, stream);
    case 128: return launch_gemm<Tag, 128>(
        a, lda, w, ldw, bias, y, rows, K, n, bm, stages, grid, stream);
    default: return launch_gemm<Tag, 256>(
        a, lda, w, ldw, bias, y, rows, K, n, bm, stages, grid, stream);
  }
}

}  // namespace pw
