// Native 2D density filter: one edge-point per cell per view.
//
// The reference's sequential occupancy pass
// (src/edgegraph3d/filtering/filtering_close_plgps.cpp:75-124), run as
// its definition: points in index order; a point is kept iff at least
// one of its observed 2D positions lands in a cell that no earlier kept
// point occupies, and a kept point then occupies all of its cells.
// filtering/density.py::density_filter_numpy is the numpy twin the tests
// hold this against, cell index for cell index.
// Exposed through a C ABI for ctypes.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Points per block of cell indices: the block's [kBlock, V] cells stay in
// the L2 cache between the two loops below.
constexpr int64_t kBlock = 512;

// The cell of coordinate v, as numpy computes
// clip((v / cell).astype(int64), 0, hi) for a Python-int `cell`: the
// quotient in T's own precision, truncated toward zero.  numpy's cast
// on x86 (cvttss2si / cvttsd2si) gives INT64_MIN for NaN, +-inf and
// quotients of magnitude 2^63 or more, and the clip makes that 0; a C++
// cast of those values is undefined, so they are spelled out: NaN fails
// both comparisons.  hi < 2^24, so T holds it exactly.
template <typename T>
inline int32_t cell_of(T v, T cell, T hi) {
  const T q = v / cell;
  return (q > T(0) && q < T(9223372036854775808.0))
             ? static_cast<int32_t>(q < hi ? q : hi)
             : 0;
}

template <typename T>
void density_keep(const T* xy, const uint8_t* mask, int64_t N, int64_t V,
                  int64_t width, int64_t height, int64_t cell,
                  uint8_t* keep) {
  // GW = ceil(width / cell) + 1, GH likewise (density.py)
  const int64_t GW = (width + cell - 1) / cell + 1;
  const int64_t GH = (height + cell - 1) / cell + 1;
  const int64_t plane = GH * GW;
  const T tc = static_cast<T>(cell);
  const T hx = static_cast<T>(GW - 1), hy = static_cast<T>(GH - 1);
  const int32_t gw = static_cast<int32_t>(GW);
  std::vector<uint8_t> occ(static_cast<size_t>(V * plane), 0);
  std::vector<int32_t> cells(static_cast<size_t>(kBlock * V));
  for (int64_t i0 = 0; i0 < N; i0 += kBlock) {
    const int64_t nb = N - i0 < kBlock ? N - i0 : kBlock;
    // every slot's cell within its view, in one loop the compiler
    // vectorises; a masked slot's cell never counts below
    const T* __restrict p = xy + i0 * V * 2;
    int32_t* __restrict c = cells.data();
    for (int64_t k = 0; k < nb * V; k++)
      c[k] = cell_of(p[2 * k + 1], tc, hy) * gw + cell_of(p[2 * k], tc, hx);
    // the reference's pass, point by point in index order.  Point i is
    // kept iff one of its observed cells is free; it then occupies all
    // of them.  Its cells lie in V different views, so marking each free
    // cell as it is tested leaves the map as marking all of them after
    // the test does: the others are occupied already.
    for (int64_t b = 0; b < nb; b++) {
      const uint8_t* m = mask + (i0 + b) * V;
      const int32_t* cb = c + b * V;
      uint8_t kept = 0;
      for (int64_t v = 0; v < V; v++) {
        uint8_t& o = occ[static_cast<size_t>(v * plane + cb[v])];
        kept |= m[v] & (o ^ 1);
        o |= m[v];
      }
      keep[i0 + b] = kept;
    }
  }
}

}  // namespace

extern "C" {

void eg3d_density_keep_f32(const float* xy, const uint8_t* mask, int64_t N,
                           int64_t V, int64_t width, int64_t height,
                           int64_t cell, uint8_t* keep) {
  density_keep<float>(xy, mask, N, V, width, height, cell, keep);
}

void eg3d_density_keep_f64(const double* xy, const uint8_t* mask, int64_t N,
                           int64_t V, int64_t width, int64_t height,
                           int64_t cell, uint8_t* keep) {
  density_keep<double>(xy, mask, N, V, width, height, cell, keep);
}

}  // extern "C"
