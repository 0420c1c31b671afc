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
// (the flipped and unflipped variants are two MXU layouts of it) with two
// kernels, run back to back by the wrapper, as the TPU's flipped kernel
// forms it (the forward's walk with its roles swapped, then _dx_finalize):
//
//   the sums walk (pointwise_conv_walk.cuh, tag DxSums): 16 candidates per
//       CTA walk every center tile (tile_idx == nullptr) or the transposed
//       CSR list, tile_idx[tile_ptr[b * n_cand_tiles + row] : ...+1] (from
//       tile_adjacency with candidates as rows), and sum each cell's
//       gradient rows on tensor cores: the forward's 0/1 cell planes with
//       each one replaced by its center's scale round(1/max(cnt, 1)),
//       times the staged round(g), mma.sync, empty cells skipped per 16 x
//       16 block.  The sums Z are rounded to the matmul type into a
//       workspace (B*Mp rows, row stride ldz >= 27*Cout, a multiple of 8);
//   the product (pointwise_conv_product.cuh, tag DxProduct), _dx_finalize's:
//       dx = round(Z) . W^T, (rows x 27*Cout) x (27*Cout x Cin), on tensor
//       cores in bf16 (f32 FMAs in f32 mode), no bias.
//
// The cell code is pair_code(candidate, center), the forward's operands,
// so pairs at exactly r and on cell faces route gradient through exactly
// the cells the forward binned them into (the TPU's flip note,
// _pairwise_code :150-154).  Every output element has one owner thread and
// every sum runs in a fixed order: no atomics, so dX repeats bit for bit
// from run to run, and the dense and CSR walks give identical bits (the
// list only drops tiles without in-ball pairs, whose cells the dense walk
// skips).
//
// What bounds it on an H100.  The walk costs what the forward's walk
// costs (the walk header's note: latency, through the codes, the per-cell
// tests and two barriers per iteration) plus, per live k-step, the scales
// of the CTA's cells staged beside g and two 32-bit shared loads per live
// cell.  The product reads the Z workspace (27*Cout bf16 per candidate)
// once.  Keeping Z out of device memory (the product fused into the walk)
// is later work.
//
// Rounding (the TPU op's _pw_bwd :1295-1308): g arrives in f32 and is
// rounded to the matmul type; 1/max(cnt, 1) is divided in f32 and rounded;
// Z accumulates in f32 and is rounded before the product; W^T is in the
// matmul type; dx accumulates and is stored in f32 (the wrapper casts it to
// the features' type).  f32 mode (off the training path, which runs bf16):
// the scale and g are each three exact bf16 terms, nine exact products.
//
// The C entry points check each launch with cudaGetLastError and return
// the first error code; the Python wrapper raises on anything but 0.

#include "pointwise_conv_product.cuh"

using namespace pw;

extern "C" {

// Dynamic shared memory of one sums-walk CTA (bytes); the wrapper refuses
// more than the card's 227 KB per block.
long long pw_dx_smem_bytes(int cout, int bf16) {
  return (long long)(bf16 ? walk_smem_bytes<DxSums, __nv_bfloat16>(cout)
                          : walk_smem_bytes<DxSums, float>(cout));
}

// bf16 elements of the walk's packed-g scratch (Nc centers).
long long pw_dx_pack_elems(int cout, int bf16, int B, int Nc) {
  return (long long)(bf16 ? walk_pack_elems<__nv_bfloat16>(cout, B, Nc)
                          : walk_pack_elems<float>(cout, B, Nc));
}

// bf16 elements of the walk's scale scratch (Nc centers).
long long pw_dx_scale_elems(int bf16, int B, int Nc) {
  return (long long)(bf16 ? walk_scale_elems<__nv_bfloat16>(B, Nc)
                          : walk_scale_elems<float>(B, Nc));
}

// The per-cell gradient sums.  pts (B, Mp, 3) are the rows, ctr (B, Ncp, 3)
// the columns; Ncp and Mp multiples of TILE; tile_ptr/tile_idx null =
// dense walk, else the candidate-tile -> center-tile list.  g (B, Ncp,
// cout) and cnt (B, Ncp, 27) f32; z (B*Mp, ldz) bf16 when bf16 != 0, else
// f32; packed and scl hold pw_dx_pack_elems and pw_dx_scale_elems bf16.
// Returns the first cudaError_t (0 = launched).
int pw_conv_dx_sums(const void* pts, const void* ctr, const void* g, const void* cnt,
                    void* packed, void* scl, const void* tile_ptr, const void* tile_idx,
                    void* z, int ldz, int B, int Mp, int Ncp, int cout, float radius, float inv,
                    int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch_walk<DxSums, T>(
        static_cast<const float*>(pts), static_cast<const float*>(ctr), g,
        static_cast<__nv_bfloat16*>(packed), static_cast<__nv_bfloat16*>(scl),
        static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_idx),
        static_cast<const float*>(cnt), nullptr, static_cast<T*>(z), ldz, B, Mp, Ncp, cout,
        radius, inv, s);
  };
  return bf16 ? f(__nv_bfloat16()) : f(float());
}

// dx (rows, cin) f32 = z (rows, ldz; K = 27*cout columns read) . wt, wt
// (K, ldw) = W^T per cell.  rows a multiple of 64.  bf16 != 0: z and wt
// bf16, ldz and ldw multiples of 8, wt zero past cin; else f32, ldw = cin.
// Returns the cudaError_t of the launch (0 = launched).
int pw_conv_dx_product(const void* z, int ldz, const void* wt, int ldw, void* dx, int rows,
                       int K, int cin, int bf16, void* stream) {
  return launch_product<DxProduct>(z, ldz, wt, ldw, nullptr, static_cast<float*>(dx), rows, K,
                                   cin, bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
