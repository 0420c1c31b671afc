// pointwise_conv_fwd.cu — forward pointwise convolution for Hopper (sm_90a).
//
// Replaces the three forward Pallas kernels of
// pointwise_tpu/kernels/pointwise_conv_pallas.py:
//   _fwd_kernel_resident (:320)  dense walk, candidate block resident in VMEM
//   _fwd_kernel          (:268)  dense walk over a (B, Nc/tn, Mp/tm) grid
//   _fwd_kernel_csr      (:599)  walk over the bbox-adjacent candidate tiles
// with two kernels, run back to back by the wrapper:
//
//   the means walk (pointwise_conv_walk.cuh, shared with dW) walks, for
//       each row tile of centers, every candidate tile (tile_idx ==
//       nullptr) or tile_idx[tile_ptr[b*n_rows + row] : ...+1], a compact
//       list (offsets plus indices) with no length cap, so the TPU's
//       degree-overflow fallback and SMEM chunking have nothing to protect
//       here.  It sums each cell's features on tensor cores (0/1 cell planes
//       x features, mma.sync, empty cells skipped per 16 x 16 block), writes
//       the walk's counts to cnt and the means, divided in f32 by
//       max(count, 1) and rounded to the matmul type, to a workspace xbar
//       (B*Ncp rows, row stride ldx >= 27*Cin, a multiple of 8);
//   pw_fwd_product_kernel, _finalize_tile's product (:297): y = xbar . W +
//       bias, (rows x 27*Cin) x (27*Cin x Cout), on tensor cores.  A CTA
//       owns 64 rows x 128 columns, 8 warps of 16 x 64, and streams xbar
//       and W through shared memory in k-steps of 32, double-buffered with
//       cp.async; ldmatrix feeds mma.sync.m16n8k16 (bf16 in, f32
//       accumulate), and the bias is added in f32 after the sum.  W is read
//       from L2 once per 64 centers.
//
// Every output row is owned by one thread per column and every sum runs in
// a fixed order: no atomics, so results repeat bit for bit from run to run,
// and the dense and CSR walks give identical bits.
//
// What bounds it on an H100.  The walk takes ~97% of the forward: latency,
// at 2 CTAs per SM (their accumulators fill the register file), through
// the codes (one pair_code per listed entry and CTA), the per-cell tests
// and two barriers per iteration (the walk header's note).  The product:
// the xbar workspace (27*Cin bf16 per center) read once from device memory
// and 2*27*Cin*Cout flops per center at the tensor cores' rate.  Sharing
// the codes across a center tile's CTAs (a cluster), fusing the product
// into the walk, wgmma and a persistent schedule are later work.
//
// External counts (replaces the ext-counts variants of the same three
// kernels, pointwise_conv_pallas_ext :1366-1403, the cnt_in argument of
// _fwd_call_resident :366, _fwd_call :1075 and _fwd_call_csr :1028): with a
// non-null cnt_in (B, Ncp, 27) the means divide by max(cnt_in, 1) instead of
// the walk's own counts, with the same rounding and product.  cnt still
// receives the walk's own counts.  The ring strategy passes the counts over
// every candidate of the space group, so the outputs of disjoint candidate
// slabs sum to the convolution over all of them; a center with positive
// cnt_in but no neighbor in the slab gets zero sums, so its output is
// exactly the bias (which the op layer keeps at zero there).
//
// bf16 mode (feats and w in bf16): features are already rounded, cell sums
// and counts stay f32, the means are divided in f32 and then rounded to
// bf16, the product accumulates in f32 and the bias is added in f32.
// f32 mode: the walk splits the features in three bf16 terms (exact, see
// the walk header); the product runs f32 FMAs on the CUDA cores
// (pw_fwd_product_f32_kernel).  f32 mode is off the serving and training
// paths (they run bf16) and serves the exactness checks, where f32
// operands on tensor cores would need six bf16 MMAs per product.
//
// The C entry points check each launch with cudaGetLastError and return the
// first error code; the Python wrapper raises on anything but 0.

#include "pointwise_conv_walk.cuh"

namespace {

using namespace pw;

constexpr int PBM = 64;     // rows per product CTA
constexpr int PBN = 128;    // columns per product CTA
constexpr int PBK = 32;     // k-step of the staged tiles
constexpr int PTHREADS = 256;

// y = xbar . w + bias (bf16 operands, f32 accumulate).  xbar (rows, ldx),
// columns >= K never read; w (K, ldw), ldw a multiple of 8 (zero columns
// past cout); grid (rows / PBM, ceil(cout / PBN)).
__global__ void __launch_bounds__(PTHREADS)
pw_fwd_product_kernel(const __nv_bfloat16* __restrict__ xbar, int ldx,
                      const __nv_bfloat16* __restrict__ w, int ldw,
                      const float* __restrict__ bias, float* __restrict__ y, int K,
                      int cout) {
  __shared__ __align__(16) __nv_bfloat16 as[2][PBM][PBK + 8];
  __shared__ __align__(16) __nv_bfloat16 bs[2][PBK][PBN + 8];
  const int r0 = blockIdx.x * PBM;
  const int o0 = blockIdx.y * PBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;   // rows wm*16.., columns wn*64..

  auto stage = [&](int kt, int buf) {
    const int k0 = kt * PBK;
    {   // A: 64 rows x 4 chunks of 8
      const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
      const int k = k0 + q * 8;
      const int valid = K - k >= 8 ? 8 : (K - k > 0 ? K - k : 0);
      const __nv_bfloat16* src = xbar + (size_t)(r0 + r) * ldx + (valid > 0 ? k : 0);
      cp_async16(&as[buf][r][q * 8], src, valid * 2);
    }
    for (int c = threadIdx.x; c < PBK * PBN / 8; c += PTHREADS) {   // B
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

  const int nk = (K + PBK - 1) / PBK;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();   // step kt landed; step kt-1 consumed
    if (kt + 1 < nk) stage(kt + 1, buf ^ 1);
#pragma unroll
    for (int ks = 0; ks < PBK / 16; ++ks) {
      unsigned a[4];
      ldsm_x4(a, &as[buf][wm * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned bb[4];
        ldsm_x4_t(bb, &bs[buf][ks * 16 + (lane & 15)][wn * 64 + p * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * p], a, bb[0], bb[1]);
        mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = o0 + wn * 64 + j * 8 + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* yr = y + (size_t)(r0 + wm * 16 + g + 8 * h) * cout;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (o + e < cout) yr[o + e] = acc[j][2 * h + e] + bias[o + e];
    }
  }
}

constexpr int FM = 64, FN = 64, FK = 32;

// f32 mode: y = xbar . w + bias with f32 FMAs in ascending k; a 64 x 64
// output tile per CTA, 4 x 4 per thread.  w (K, cout).
__global__ void __launch_bounds__(PTHREADS)
pw_fwd_product_f32_kernel(const float* __restrict__ xbar, int ldx,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          float* __restrict__ y, int K, int cout) {
  __shared__ float as[FK][FM + 1];   // +1: the transposing stores spread over banks
  __shared__ float bs[FK][FN];
  const int r0 = blockIdx.x * FM;
  const int o0 = blockIdx.y * FN;
  const int tx = threadIdx.x % 16;    // columns o0 + tx*4 .. +3
  const int ty = threadIdx.x / 16;    // rows r0 + ty*4 .. +3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = threadIdx.x; i < FK * FM; i += PTHREADS) {
      const int r = i / FK, kk = i % FK;
      as[kk][r] = k0 + kk < K ? xbar[(size_t)(r0 + r) * ldx + k0 + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < FK * FN; i += PTHREADS) {
      const int kk = i / FN, c = i % FN;
      bs[kk][c] = (k0 + kk < K && o0 + c < cout) ? w[(size_t)(k0 + kk) * cout + o0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < cout) y[(size_t)(r0 + ty * 4 + i) * cout + o] = acc[i][j] + bias[o];
    }
  }
}

}  // namespace

extern "C" {

// The candidate tile, read by the Python wrapper to check its own copy.
int pw_conv_tile() { return TILE; }

// The widest Cin (and Cout) the forward and dW kernels take.
int pw_conv_max_width() { return MAX_WIDTH; }

// Dynamic shared memory of one walk CTA (bytes); the wrapper refuses more
// than the card's 227 KB per block.
long long pw_conv_smem_bytes(int cin, int bf16) {
  return (long long)(bf16 ? walk_smem_bytes<__nv_bfloat16>(cin) : walk_smem_bytes<float>(cin));
}

// bf16 elements of the walk's packed-feature scratch.
long long pw_conv_pack_elems(int cin, int bf16, int B, int Mp) {
  return (long long)(bf16 ? walk_pack_elems<__nv_bfloat16>(cin, B, Mp)
                          : walk_pack_elems<float>(cin, B, Mp));
}

// The means walk.  Ncp and Mp multiples of TILE; tile_ptr/tile_idx null =
// dense walk; cnt_in null = divide by the walk's own counts, which go to
// cnt.  feats and xbar (B*Ncp, ldx) are bf16 when bf16 != 0, else f32;
// packed holds pw_conv_pack_elems bf16.  Returns the first cudaError_t (0 =
// launched).
int pw_conv_fwd_means(const void* ctr, const void* pts, const void* feats, void* packed,
                      const void* tile_ptr, const void* tile_idx, const void* cnt_in,
                      void* cnt, void* xbar, int ldx, int B, int Ncp, int Mp, int cin,
                      float radius, float inv, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch_walk<FwdMeans, T>(static_cast<const float*>(ctr), static_cast<const float*>(pts),
                          static_cast<const T*>(feats), static_cast<__nv_bfloat16*>(packed),
                          static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
                          static_cast<const float*>(cnt_in), static_cast<float*>(cnt),
                          static_cast<T*>(xbar), ldx, B, Ncp, Mp, cin, radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

// y (rows, cout) f32 = xbar (rows, ldx; K = 27*cin columns read) . w + bias.
// rows a multiple of 64.  bf16 != 0: xbar and w bf16, ldx and ldw multiples
// of 8, w (K, ldw) zero past cout; else f32, w (K, cout).  Returns the
// cudaError_t of the launch (0 = launched).
int pw_conv_fwd_product(const void* xbar, int ldx, const void* w, int ldw,
                        const void* bias, void* y, int rows, int K, int cout, int bf16,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dim3 grid(rows / PBM, (cout + PBN - 1) / PBN);
    pw_fwd_product_kernel<<<grid, PTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xbar), ldx, static_cast<const __nv_bfloat16*>(w),
        ldw, static_cast<const float*>(bias), static_cast<float*>(y), K, cout);
  } else {
    dim3 grid(rows / FM, (cout + FN - 1) / FN);
    pw_fwd_product_f32_kernel<<<grid, PTHREADS, 0, s>>>(
        static_cast<const float*>(xbar), ldx, static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), K, cout);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
