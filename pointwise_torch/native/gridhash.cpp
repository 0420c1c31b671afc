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
//   gh_presort: a scan's bounding box, Morton codes, stable radix argsort
//               and gather, in linear time (the streaming engine's presort)
//   gh_sched_mark / gh_sched_emit : one tile's nested candidate sets and
//               their gather schedule, in one walk of the tile's cells
//   gh_crop   : every chunk of a room's sliding-block crop, Morton-sorted,
//               centred and featured, in one threaded pass
//
// Built by native/__init__.py (g++ -O3 -shared -fPIC -pthread).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

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

namespace {

// Run fn(begin, end, t) over [0, n) cut into nt contiguous slices, slice t
// on a thread of its own (slice 0 on the caller's).
template <class F>
void parallel_slices(int nt, int64_t n, F fn) {
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t)
    pool.emplace_back(fn, n * t / nt, n * (t + 1) / nt, t);
  fn(0, n / nt, 0);
  for (auto& th : pool) th.join();
}

// Holds each of n threads at wait() until all n have reached it.
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(m_);
    const int64_t gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    cv_.wait(lock, [&] { return gen_ != gen; });
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  const int n_;
  int count_ = 0;
  int64_t gen_ = 0;
};

constexpr int kDigitBits = 10;          // three digits hold the 30 bits
constexpr int kBuckets = 1 << kDigitBits;

}  // namespace

extern "C" {

// The streaming engine's presort in one call: the bounding box (lo, hi),
// gh_morton's codes over it, a stable argsort of the codes and the points
// and features gathered into that order.  The argsort is an LSD radix sort
// of the keys code << 32 | index over three 10-bit digits: ties keep their
// input order, as np.argsort(codes, kind="stable") does.  Each of up to
// ``threads`` threads takes one contiguous slice through every step, the
// steps parted by barriers; every step is per element or a stable counting
// pass, so no bit depends on the thread count.  Requires n >= 1.
void gh_presort(const float* pts, const float* feats, int64_t n, int64_t c,
                int threads,
                float* lo, float* hi,           // out: (3) each
                int64_t* order,                 // out: (n)
                float* pts_out,                 // out: (n, 3)
                float* feats_out) {             // out: (n, c)
  const int nt = (int)std::max<int64_t>(
      1, std::min<int64_t>(threads, n / 32768));
  // the sort's two key arrays, kept by the calling thread from call to
  // call: fresh pages would cost a fault each, more than the sort itself
  thread_local std::vector<uint64_t> scratch;
  if ((int64_t)scratch.size() < 2 * n) scratch.resize(2 * n);
  uint64_t* const keys = scratch.data();
  uint64_t* const tmp = keys + n;
  std::vector<float> ext(6 * nt);
  std::vector<int64_t> hist((size_t)nt * kBuckets);   // per slice
  Barrier barrier(nt);
  parallel_slices(nt, n, [&](int64_t b, int64_t e, int t) {
    float m[6] = {pts[3 * b], pts[3 * b + 1], pts[3 * b + 2],
                  pts[3 * b], pts[3 * b + 1], pts[3 * b + 2]};
    for (int64_t i = b; i < e; ++i)
      for (int a = 0; a < 3; ++a) {
        const float v = pts[3 * i + a];
        m[a] = std::min(m[a], v);
        m[3 + a] = std::max(m[3 + a], v);
      }
    std::copy(m, m + 6, &ext[6 * t]);
    barrier.wait();
    float blo[3], bhi[3], span[3];      // every thread reduces alike
    for (int a = 0; a < 3; ++a) {
      blo[a] = ext[a];
      bhi[a] = ext[3 + a];
      for (int s = 1; s < nt; ++s) {
        blo[a] = std::min(blo[a], ext[6 * s + a]);
        bhi[a] = std::max(bhi[a], ext[6 * s + 3 + a]);
      }
      span[a] = bhi[a] - blo[a];
    }
    if (t == 0) {
      std::copy(blo, blo + 3, lo);
      std::copy(bhi, bhi + 3, hi);
    }
    uint32_t* codes = reinterpret_cast<uint32_t*>(tmp);
    gh_morton(pts + 3 * b, e - b, blo, span, codes + b);
    for (int64_t i = b; i < e; ++i)
      keys[i] = ((uint64_t)codes[i] << 32) | (uint64_t)i;
    // one stable scatter per digit: slice t writes each bucket's entries
    // after those of every earlier slice
    uint64_t* src = keys;
    uint64_t* dst = tmp;
    int64_t* cur = &hist[(size_t)t * kBuckets];
    for (int d = 0; d < 3; ++d) {
      const int shift = 32 + kDigitBits * d;
      std::fill(cur, cur + kBuckets, 0);
      for (int64_t i = b; i < e; ++i) ++cur[(src[i] >> shift) & (kBuckets - 1)];
      barrier.wait();
      if (t == 0) {
        int64_t run = 0;
        for (int k = 0; k < kBuckets; ++k)
          for (int s = 0; s < nt; ++s) {
            const int64_t m = hist[(size_t)s * kBuckets + k];
            hist[(size_t)s * kBuckets + k] = run;
            run += m;
          }
      }
      barrier.wait();
      for (int64_t i = b; i < e; ++i)
        dst[cur[(src[i] >> shift) & (kBuckets - 1)]++] = src[i];
      barrier.wait();
      std::swap(src, dst);
    }
    constexpr int64_t kAhead = 16;      // rows prefetched ahead of the gather
    for (int64_t i = b; i < e; ++i) {
      if (i + kAhead < e) {
        const int64_t f = (int64_t)(src[i + kAhead] & 0xFFFFFFFFu);
        __builtin_prefetch(pts + 3 * f);
        __builtin_prefetch(feats + c * f);
      }
      const int64_t j = (int64_t)(src[i] & 0xFFFFFFFFu);
      order[i] = j;
      pts_out[3 * i] = pts[3 * j];
      pts_out[3 * i + 1] = pts[3 * j + 1];
      pts_out[3 * i + 2] = pts[3 * j + 2];
      std::memcpy(feats_out + c * i, feats + c * j, sizeof(float) * c);
    }
  });
}

// One tile's nested candidate sets, first of two calls.  Box l is
// [box_lo[l], box_hi[l]) (3 floats each), box 0 the outermost, every box
// inside the one before it.  Walks the grid cells under box 0 once and
// sets depth[i] to the number of boxes holding point i (gh_query's own
// comparisons, so box l holds exactly what gh_query returns for it), then
// depth L + 1 on the points of grid cell ``cell`` (the tile's interior,
// inside every box).  S_k, for k = 0..L, is the points of depth > k:
// writes counts[k] = |S_k| and the first and last marked index to
// ``span``.  ``depth`` is the caller's buffer of n zero bytes (so
// L < 255); gh_sched_emit zeroes it again.
void gh_sched_mark(const float* pts, const float* origin, float h,
                   const int32_t* dims, const int32_t* cell_starts,
                   const int32_t* order, int64_t cell, int32_t L,
                   const float* box_lo, const float* box_hi,
                   uint8_t* depth,
                   int32_t* counts,             // out: (L + 1)
                   int64_t* span) {             // out: (2)
  const int64_t ny = dims[1], nz = dims[2];
  const float inv = 1.0f / h;
  int64_t c0[3], c1[3];
  for (int a = 0; a < 3; ++a) {
    const int64_t m = dims[a] - 1;
    c0[a] = (int64_t)std::floor((box_lo[a] - origin[a]) * inv);
    c1[a] = (int64_t)std::floor((box_hi[a] - origin[a]) * inv);
    c0[a] = std::min(std::max(c0[a], (int64_t)0), m);
    c1[a] = std::min(std::max(c1[a], (int64_t)0), m);
  }
  std::vector<int64_t> hist(L + 2, 0);
  int64_t first = INT64_MAX, last = -1;
  for (int64_t cx = c0[0]; cx <= c1[0]; ++cx)
    for (int64_t cy = c0[1]; cy <= c1[1]; ++cy) {
      const int64_t base = (cx * ny + cy) * nz;
      for (int32_t k = cell_starts[base + c0[2]];
           k < cell_starts[base + c1[2] + 1]; ++k) {
        const int32_t i = order[k];
        const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
        int d = 0;
        while (d < L) {
          const float* l = box_lo + 3 * d;
          const float* u = box_hi + 3 * d;
          if (!(x >= l[0] && x < u[0] && y >= l[1] && y < u[1] &&
                z >= l[2] && z < u[2]))
            break;
          ++d;
        }
        if (d) {
          depth[i] = (uint8_t)d;
          ++hist[d];
          first = std::min<int64_t>(first, i);
          last = std::max<int64_t>(last, i);
        }
      }
    }
  for (int32_t k = cell_starts[cell]; k < cell_starts[cell + 1]; ++k) {
    const int32_t i = order[k];
    --hist[depth[i]];
    ++hist[L + 1];
    depth[i] = (uint8_t)(L + 1);
    first = std::min<int64_t>(first, i);
    last = std::max<int64_t>(last, i);
  }
  int64_t above = 0;                    // points of depth > k
  for (int k = L; k >= 0; --k) {
    above += hist[k + 1];
    counts[k] = (int32_t)above;
  }
  span[0] = first;
  span[1] = last;
}

// Second call: scans depth[span[0]..span[1]] in ascending index order,
// zeroing it, and writes S_0 (``s0``, ascending) and the gather schedule
// of the nested sets, with l = 0..L-1 and S_L the interior:
//   sels[l]  (at offset counts[1] + .. + counts[l], length counts[l+1]):
//            the positions within S_l of S_{l+1};
//   skips[l] (at l * counts[L], length counts[L]): the positions within
//            S_{l+1} of the interior.
void gh_sched_emit(uint8_t* depth, const int64_t* span, int32_t L,
                   const int32_t* counts,
                   int32_t* s0, int32_t* sels, int32_t* skips) {
  std::vector<int64_t> off(L + 1, 0), r(L + 1, 0);   // r[k]: |S_k| so far
  for (int l = 0; l < L; ++l) off[l + 1] = off[l] + counts[l + 1];
  const int64_t n_in = counts[L];
  for (int64_t i = span[0]; i <= span[1]; ++i) {
    const int d = depth[i];
    if (!d) continue;
    depth[i] = 0;
    s0[r[0]] = (int32_t)i;
    for (int l = 0; l + 1 < d; ++l)
      sels[off[l] + r[l + 1]] = (int32_t)r[l];
    if (d == L + 1)
      for (int l = 0; l < L; ++l) skips[l * n_in + r[L]] = (int32_t)r[l + 1];
    for (int k = 0; k < d; ++k) ++r[k];
  }
}

// The sliding-block crop's emission (data/s3dis.py ``_emit_block``) for
// every chunk of a room at once.  Chunk k is the room's points
// rows[k * m .. k * m + m) (m = num_points); per chunk: gh_morton's codes
// over the chunk's own bounding box, a stable argsort of them (an LSD radix
// sort of code << 32 | position over three 10-bit digits), and, at output
// position i of the sorted point r:
//   points[k, i]   = xyz[r] - (centers[k, 0], centers[k, 1], 0)
//   features[k, i] = rgb[r], then (xyz[r] - mins) / span when rgb_norm
//   label[k, i] = label_in[r], mask[k, i] = 1, index[k, i] = r.
// The same float32 operations as the NumPy steps, so the same bits.
// Chunks are independent: up to ``threads`` threads take contiguous runs
// of them.  Requires 1 <= m < 2^32.
void gh_crop(const float* xyz, const float* rgb, const int32_t* label_in,
             const float* mins, const float* span,
             const int64_t* rows, const float* centers,
             int64_t chunks, int64_t m, int rgb_norm, int threads,
             float* points,                     // out: (chunks, m, 3)
             float* features,                   // out: (chunks, m, 6 or 3)
             int32_t* label,                    // out: (chunks, m)
             float* mask,                       // out: (chunks, m)
             int32_t* index) {                  // out: (chunks, m)
  const int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, chunks));
  const int64_t c = rgb_norm ? 6 : 3;
  parallel_slices(nt, chunks, [&](int64_t b, int64_t e, int) {
    std::vector<float> pts(3 * m);
    std::vector<uint32_t> codes(m);
    std::vector<uint64_t> keys(m), tmp(m);
    std::vector<int64_t> count(kBuckets);
    for (int64_t k = b; k < e; ++k) {
      const int64_t* row = rows + k * m;
      float lo[3], ext[3];
      for (int a = 0; a < 3; ++a) lo[a] = ext[a] = xyz[3 * row[0] + a];
      for (int64_t j = 0; j < m; ++j)
        for (int a = 0; a < 3; ++a) {
          const float v = xyz[3 * row[j] + a];
          pts[3 * j + a] = v;
          lo[a] = std::min(lo[a], v);
          ext[a] = std::max(ext[a], v);
        }
      for (int a = 0; a < 3; ++a) ext[a] -= lo[a];
      gh_morton(pts.data(), m, lo, ext, codes.data());
      for (int64_t j = 0; j < m; ++j)
        keys[j] = ((uint64_t)codes[j] << 32) | (uint64_t)j;
      uint64_t* src = keys.data();
      uint64_t* dst = tmp.data();
      for (int d = 0; d < 3; ++d) {
        const int shift = 32 + kDigitBits * d;
        std::fill(count.begin(), count.end(), 0);
        for (int64_t j = 0; j < m; ++j)
          ++count[(src[j] >> shift) & (kBuckets - 1)];
        int64_t run = 0;
        for (int q = 0; q < kBuckets; ++q) {
          const int64_t n_q = count[q];
          count[q] = run;
          run += n_q;
        }
        for (int64_t j = 0; j < m; ++j)
          dst[count[(src[j] >> shift) & (kBuckets - 1)]++] = src[j];
        std::swap(src, dst);
      }
      const float cx = centers[2 * k], cy = centers[2 * k + 1];
      for (int64_t i = 0; i < m; ++i) {
        const int64_t j = (int64_t)(src[i] & 0xFFFFFFFFu);
        const int64_t r = row[j];
        const float* p = &pts[3 * j];
        float* o = points + 3 * (k * m + i);
        o[0] = p[0] - cx;
        o[1] = p[1] - cy;
        o[2] = p[2] - 0.0f;
        float* f = features + c * (k * m + i);
        f[0] = rgb[3 * r];
        f[1] = rgb[3 * r + 1];
        f[2] = rgb[3 * r + 2];
        if (rgb_norm)
          for (int a = 0; a < 3; ++a) f[3 + a] = (p[a] - mins[a]) / span[a];
        label[k * m + i] = label_in[r];
        mask[k * m + i] = 1.0f;
        index[k * m + i] = (int32_t)r;
      }
    }
  });
}

}  // extern "C"
