// Per-query bodies of K1 grid_topm_query and K2 epipolar_topm_query,
// shared by those kernels and by K7 expand_chains, so every caller makes
// each decision with the same arithmetic in the same order.
//
// A grid entry is 6 f32 (pl, seg, ax, ay, bx, by) at a 24-byte stride;
// it is read as 8-byte float2 loads through the read-only path (the
// wrappers check that the grid stack is 8-byte aligned): (pl, seg)
// first, and the segment's endpoints only when pl >= 0 (most slots of a
// cell are empty).
//
// The queries' coordinates, lines and outputs are of the compute scalar T
// (float, or double in the f64 bodies); an expression between two grid
// values stays f32, as it does in the JAX package under x64 (e.g. a
// segment's b - a), and promotes where it meets a T (common.cuh).  K2's
// observation point may be f32 while its line is f64 (the stage-3
// seeding's starts): its type Q sets the cell lookup's division.
#pragma once

#include "common.cuh"

namespace eg3d {

struct Entry {
  int pl, seg;
  float ax, ay, bx, by;
};

// Reads the entry at e into *en; false (endpoints unread) for an empty
// slot (pl < 0).
static __device__ __forceinline__ bool load_entry(const float* __restrict__ e,
                                                  Entry* en) {
  const float2* p = reinterpret_cast<const float2*>(e);
  const float2 a = __ldg(p);
  en->pl = (int)a.x;
  if (en->pl < 0) return false;
  const float2 b = __ldg(p + 1), c = __ldg(p + 2);
  en->seg = (int)a.y;
  en->ax = b.x;
  en->ay = b.y;
  en->bx = c.x;
  en->by = c.y;
  return true;
}

// First float of entry k of cell (xx, yy) on view v.
static __device__ __forceinline__ const float* entry_ptr(
    const float* __restrict__ grids, int GH, int GW, int Kc, int64_t v,
    int yy, int xx, int k) {
  return grids + ((((v * GH + yy) * GW + xx) * Kc) + k) * 6;
}

// The [Q, M] outputs of K1 and K2: polyline, segment, parameter,
// point (2 values), distance and valid flag of each of a query's M
// candidates, in the query's compute type Q.
template <class Q>
struct Out {
  int* pl;
  int* seg;
  Q* t;
  Q* xy;
  Q* dist;
  uint8_t* valid;
};

// Store N values at dst (aligned to 4 N bytes for N % 4 == 0, 2 N for
// N == 2) in 16- or 8-byte pieces.
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_row(double* dst, const double (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<double2*>(dst)[i] = make_double2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_row(int* dst, const int (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<int4*>(dst)[i] =
          make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const uint8_t (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<uchar4*>(dst)[i] =
          make_uchar4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uchar2*>(dst) = make_uchar2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

// Query q's row of every output: the values TopM::store writes, row by
// row (K1 and K2).
template <int M, class Q>
__device__ __forceinline__ void store_rows(const TopM<M, Q>& top, int64_t q,
                                           const Out<Q>& o) {
  int pl[M], seg[M];
  Q t[M], xy[2 * M], dist[M];
  uint8_t valid[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const bool ok = top.ok(i);
    pl[i] = ok ? top.pl[i] : -1;
    seg[i] = ok ? top.seg[i] : 0;
    t[i] = ok ? top.t[i] : Q(0);
    xy[2 * i] = ok ? top.x[i] : Q(0);
    xy[2 * i + 1] = ok ? top.y[i] : Q(0);
    dist[i] = ok ? top.d[i] : big<Q>();
    valid[i] = ok ? 1 : 0;
  }
  store_row(o.pl + q * M, pl);
  store_row(o.seg + q * M, seg);
  store_row(o.t + q * M, t);
  store_row(o.xy + q * 2 * M, xy);
  store_row(o.dist + q * M, dist);
  store_row(o.valid + q * M, valid);
}

// K1's test of one non-empty entry against the point (px, py): the
// point-segment distance, offered to the top-M when within `radius`.
template <int M, class T>
__device__ __forceinline__ void grid_entry(const Entry& en, T px, T py,
                                           T radius, TopM<M, T>& top) {
  const float ux = en.bx - en.ax;
  const float uy = en.by - en.ay;
  const float denom = nmax(ux * ux + uy * uy, 1e-12f);
  const T t = clip01(((px - en.ax) * ux + (py - en.ay) * uy) / denom);
  const T qx = en.ax + t * ux;
  const T qy = en.ay + t * uy;
  const T dx = px - qx;
  const T dy = py - qy;
  const T d = vsqrt(dx * dx + dy * dy);
  if (d <= radius) top.offer(d, en.pl, en.seg, t, qx, qy);
}

// K1's query: the 3x3 cells around (px, py) on view v (clipped at the
// image border, so border cells repeat exactly as the reference's gather
// does), Kc entries (pl, seg, ax, ay, bx, by) per cell, the point-segment
// distance, entries within `radius` offered to the top-M of distinct
// polylines.  K1's generic body (any Kc) and K7 run it.
template <int M, class T>
__device__ __forceinline__ void grid_topm_one(const float* __restrict__ grids,
                                              int GH, int GW, int Kc,
                                              int64_t v, T px, T py, T cell,
                                              T radius, TopM<M, T>& top) {
  const int cx = cell_of(px, cell, GW);
  const int cy = cell_of(py, cell, GH);
  top.init();
  for (int oy = -1; oy <= 1; ++oy) {
    const int yy = clampi(cy + oy, 0, GH - 1);
    for (int ox = -1; ox <= 1; ++ox) {
      const int xx = clampi(cx + ox, 0, GW - 1);
      const float* e = entry_ptr(grids, GH, GW, Kc, v, yy, xx, 0);
      for (int k = 0; k < Kc; ++k, e += 6) {
        Entry en;
        if (!load_entry(e, &en)) continue;
        grid_entry(en, px, py, radius, top);
      }
    }
  }
}

// K2's test of one entry against the normalized line (l0, l1, l2) and
// the observation (ox, oy): true when the segment crosses the line
// within `rad` (optionally not quasi-parallel, |cos| >= excl_cos), with
// the distance, the crossing parameter and the crossing point.
template <class T, class Q>
static __device__ __forceinline__ bool epipolar_entry(
    const Entry& en, Q ox, Q oy, T l0, T l1, T l2, T rad, int use_excl,
    T excl_cos, T* d, T* s_out, T* x_out, T* y_out) {
  const T sa = en.ax * l0 + en.ay * l1 + l2;
  const T sb = en.bx * l0 + en.by * l1 + l2;
  const T diff = sa - sb;
  const bool parallel = vabs(diff) < T(1e-9);
  const T s = parallel ? T(0) : sa / diff;
  bool crosses = (sa * sb <= T(0)) && !parallel && (s >= T(0)) && (s <= T(1));
  const float abx = en.bx - en.ax;
  const float aby = en.by - en.ay;
  if (use_excl) {
    const float len = nmax(sqrtf(abx * abx + aby * aby), 1e-12f);
    const T c = vabs(abx * (-l1) + aby * l0) / len;
    crosses = crosses && (c < excl_cos);
  }
  if (!crosses) return false;
  const T x = en.ax + s * abx;
  const T y = en.ay + s * aby;
  const T ex = x - ox;
  const T ey = y - oy;
  *d = vsqrt(ex * ex + ey * ey);
  *s_out = s;
  *x_out = x;
  *y_out = y;
  return *d <= rad;
}

// K2's query, one thread: the 5x5 cells around the observation (ox, oy)
// on view v, every entry's segment intersected with the normalized line,
// crossings within `rad` offered to the top-M of distinct polylines in
// the reference's gather order.  K7's "epipolar" mode runs it per point.
template <int M, class T, class Q>
__device__ __forceinline__ void epipolar_topm_one(
    const float* __restrict__ grids, int GH, int GW, int Kc, int64_t v,
    Q ox, Q oy, T l0, T l1, T l2, T rad, Q cell, int use_excl, T excl_cos,
    TopM<M, T>& top) {
  const int cx = cell_of(ox, cell, GW);
  const int cy = cell_of(oy, cell, GH);
  top.init();
  for (int dy = -2; dy <= 2; ++dy) {
    const int yy = clampi(cy + dy, 0, GH - 1);
    for (int dx = -2; dx <= 2; ++dx) {
      const int xx = clampi(cx + dx, 0, GW - 1);
      const float* e = entry_ptr(grids, GH, GW, Kc, v, yy, xx, 0);
      for (int k = 0; k < Kc; ++k, e += 6) {
        Entry en;
        if (!load_entry(e, &en)) continue;
        T d, s, x, y;
        if (epipolar_entry(en, ox, oy, l0, l1, l2, rad, use_excl, excl_cos,
                           &d, &s, &x, &y))
          top.offer(d, en.pl, en.seg, s, x, y);
      }
    }
  }
}

}  // namespace eg3d
