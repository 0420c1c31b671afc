// gridhash.cpp — native spatial grid index for the host-side data path.
//
// A copy of pointwise_tpu/native/gridhash.cpp for the PyTorch package (the
// port imports nothing of the JAX package).  The conv itself runs in the
// CUDA kernels under pointwise_torch/kernels/csrc/; what remains hot on
// the host at ~1M-point scale is the spatial indexing that feeds the chip:
// binning a scan into blocks, and box queries with halo margins for exact
// overlap-save streaming inference.  NumPy does this at ~100MB/s of
// temporaries; this counting-sort implementation is allocation-free per
// call and memory-bandwidth bound.
//
// Exposed C ABI (ctypes-friendly, all buffers caller-allocated):
//   gh_build  : counting-sort points into a uniform grid
//               -> cell id per point, CSR starts, permutation
//   gh_query  : gather indices of all points inside an AABB (via the grid)
//   gh_morton : 30-bit Morton codes for spatial sorting
//
// Build: see build.sh (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Quantize each point to its grid cell. Grid has dims[0]*dims[1]*dims[2]
// cells of size h starting at origin. Returns 0 on success.
int gh_build(const float* pts, int64_t n,
             const float* origin, float h,
             const int32_t* dims,
             int32_t* cell_of_point,     // out: (n)
             int32_t* cell_starts,       // out: (ncells+1) CSR offsets
             int32_t* order) {           // out: (n) point idx sorted by cell
  const int64_t nx = dims[0], ny = dims[1], nz = dims[2];
  const int64_t ncells = nx * ny * nz;
  const float inv = 1.0f / h;
  // pass 1: cell ids + histogram
  std::memset(cell_starts, 0, sizeof(int32_t) * (ncells + 1));
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = (int64_t)((pts[3 * i + 0] - origin[0]) * inv);
    int64_t cy = (int64_t)((pts[3 * i + 1] - origin[1]) * inv);
    int64_t cz = (int64_t)((pts[3 * i + 2] - origin[2]) * inv);
    cx = std::min(std::max(cx, (int64_t)0), nx - 1);
    cy = std::min(std::max(cy, (int64_t)0), ny - 1);
    cz = std::min(std::max(cz, (int64_t)0), nz - 1);
    const int32_t c = (int32_t)((cx * ny + cy) * nz + cz);
    cell_of_point[i] = c;
    cell_starts[c + 1]++;
  }
  // prefix sum
  for (int64_t c = 0; c < ncells; ++c) cell_starts[c + 1] += cell_starts[c];
  // pass 2: scatter (stable counting sort)
  // reuse a scratch cursor on the stack? needs ncells ints; caller gives us
  // cell_starts which we must keep, so cursor = copy in order buffer trick:
  // we do a second histogram pass with a small heap allocation.
  int32_t* cursor = new int32_t[ncells];
  std::memcpy(cursor, cell_starts, sizeof(int32_t) * ncells);
  for (int64_t i = 0; i < n; ++i) {
    order[cursor[cell_of_point[i]]++] = (int32_t)i;
  }
  delete[] cursor;
  return 0;
}

// Count + gather indices of points with lo <= p < hi (AABB), walking only
// intersecting grid cells. Returns number written (capped at cap).
int64_t gh_query(const float* pts, int64_t n,
                 const float* origin, float h, const int32_t* dims,
                 const int32_t* cell_starts, const int32_t* order,
                 const float* lo, const float* hi,
                 int32_t* out_idx, int64_t cap) {
  const int64_t nx = dims[0], ny = dims[1], nz = dims[2];
  const float inv = 1.0f / h;
  int64_t cx0 = (int64_t)std::floor((lo[0] - origin[0]) * inv);
  int64_t cy0 = (int64_t)std::floor((lo[1] - origin[1]) * inv);
  int64_t cz0 = (int64_t)std::floor((lo[2] - origin[2]) * inv);
  int64_t cx1 = (int64_t)std::floor((hi[0] - origin[0]) * inv);
  int64_t cy1 = (int64_t)std::floor((hi[1] - origin[1]) * inv);
  int64_t cz1 = (int64_t)std::floor((hi[2] - origin[2]) * inv);
  cx0 = std::min(std::max(cx0, (int64_t)0), nx - 1);
  cy0 = std::min(std::max(cy0, (int64_t)0), ny - 1);
  cz0 = std::min(std::max(cz0, (int64_t)0), nz - 1);
  cx1 = std::min(std::max(cx1, (int64_t)0), nx - 1);
  cy1 = std::min(std::max(cy1, (int64_t)0), ny - 1);
  cz1 = std::min(std::max(cz1, (int64_t)0), nz - 1);
  int64_t m = 0;
  for (int64_t cx = cx0; cx <= cx1; ++cx)
    for (int64_t cy = cy0; cy <= cy1; ++cy) {
      const int64_t base = (cx * ny + cy) * nz;
      // contiguous z-run of cells -> one CSR span
      const int64_t c_lo = base + cz0, c_hi = base + cz1;
      for (int32_t k = cell_starts[c_lo]; k < cell_starts[c_hi + 1]; ++k) {
        const int32_t i = order[k];
        const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
        if (x >= lo[0] && x < hi[0] && y >= lo[1] && y < hi[1] &&
            z >= lo[2] && z < hi[2]) {
          if (m < cap) out_idx[m] = i;
          ++m;
        }
      }
    }
  return m;  // may exceed cap: caller re-queries with a bigger buffer
}

// 30-bit Morton codes (10 bits/axis) over the bbox [origin, origin+span].
void gh_morton(const float* pts, int64_t n,
               const float* origin, const float* span,
               uint32_t* codes) {
  auto part1by2 = [](uint32_t x) {
    x &= 0x3FF;
    x = (x | (x << 16)) & 0x030000FF;
    x = (x | (x << 8)) & 0x0300F00F;
    x = (x | (x << 4)) & 0x030C30C3;
    x = (x | (x << 2)) & 0x09249249;
    return x;
  };
  for (int64_t i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int a = 0; a < 3; ++a) {
      float s = span[a] > 1e-9f ? span[a] : 1e-9f;
      float t = (pts[3 * i + a] - origin[a]) / s;
      t = std::min(std::max(t, 0.0f), 1.0f);
      q[a] = (uint32_t)(t * 1023.0f);
    }
    codes[i] = (part1by2(q[0]) << 2) | (part1by2(q[1]) << 1) | part1by2(q[2]);
  }
}

}  // extern "C"
