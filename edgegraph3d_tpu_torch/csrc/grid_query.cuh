// Per-query bodies of K1 grid_topm_query and K2 epipolar_topm_query,
// shared by those kernels and by K7 expand_chains, so every caller makes
// each decision with the same arithmetic in the same order.
//
// A grid entry is 6 f32 (pl, seg, ax, ay, bx, by) at a 24-byte stride;
// it is read as 8-byte float2 loads through the read-only path (the
// wrappers check that the grid stack is 8-byte aligned): (pl, seg)
// first, and the segment's endpoints only when pl >= 0 (most slots of a
// cell are empty).
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

// K1's test of one non-empty entry against the point (px, py): the
// point-segment distance, offered to the top-M when within `radius`.
template <int M>
__device__ __forceinline__ void grid_entry(const Entry& en, float px,
                                           float py, float radius,
                                           TopM<M>& top) {
  const float ux = en.bx - en.ax;
  const float uy = en.by - en.ay;
  const float denom = nmax(ux * ux + uy * uy, 1e-12f);
  const float t = clip01(((px - en.ax) * ux + (py - en.ay) * uy) / denom);
  const float qx = en.ax + t * ux;
  const float qy = en.ay + t * uy;
  const float dx = px - qx;
  const float dy = py - qy;
  const float d = sqrtf(dx * dx + dy * dy);
  if (d <= radius) top.offer(d, en.pl, en.seg, t, qx, qy);
}

// K1's query: the 3x3 cells around (px, py) on view v (clipped at the
// image border, so border cells repeat exactly as the reference's gather
// does), Kc entries (pl, seg, ax, ay, bx, by) per cell, the point-segment
// distance, entries within `radius` offered to the top-M of distinct
// polylines.  K1's generic body (any Kc) and K7 run it.
template <int M>
__device__ __forceinline__ void grid_topm_one(const float* __restrict__ grids,
                                              int GH, int GW, int Kc,
                                              int64_t v, float px, float py,
                                              float cell, float radius,
                                              TopM<M>& top) {
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
static __device__ __forceinline__ bool epipolar_entry(
    const Entry& en, float ox, float oy, float l0, float l1, float l2,
    float rad, int use_excl, float excl_cos, float* d, float* s_out,
    float* x_out, float* y_out) {
  const float sa = en.ax * l0 + en.ay * l1 + l2;
  const float sb = en.bx * l0 + en.by * l1 + l2;
  const float diff = sa - sb;
  const bool parallel = fabsf(diff) < 1e-9f;
  const float s = parallel ? 0.0f : sa / diff;
  bool crosses =
      (sa * sb <= 0.0f) && !parallel && (s >= 0.0f) && (s <= 1.0f);
  const float abx = en.bx - en.ax;
  const float aby = en.by - en.ay;
  if (use_excl) {
    const float len = nmax(sqrtf(abx * abx + aby * aby), 1e-12f);
    const float c = fabsf(abx * (-l1) + aby * l0) / len;
    crosses = crosses && (c < excl_cos);
  }
  if (!crosses) return false;
  const float x = en.ax + s * abx;
  const float y = en.ay + s * aby;
  const float ex = x - ox;
  const float ey = y - oy;
  *d = sqrtf(ex * ex + ey * ey);
  *s_out = s;
  *x_out = x;
  *y_out = y;
  return *d <= rad;
}

// K2's query, one thread: the 5x5 cells around the observation (ox, oy)
// on view v, every entry's segment intersected with the normalized line,
// crossings within `rad` offered to the top-M of distinct polylines in
// the reference's gather order.  K7's "epipolar" mode runs it per point.
template <int M>
__device__ __forceinline__ void epipolar_topm_one(
    const float* __restrict__ grids, int GH, int GW, int Kc, int64_t v,
    float ox, float oy, float l0, float l1, float l2, float rad, float cell,
    int use_excl, float excl_cos, TopM<M>& top) {
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
        float d, s, x, y;
        if (epipolar_entry(en, ox, oy, l0, l1, l2, rad, use_excl, excl_cos,
                           &d, &s, &x, &y))
          top.offer(d, en.pl, en.seg, s, x, y);
      }
    }
  }
}

// Top-M distinct polylines keyed by (distance, arrival index), keys
// only, for a query split over a group of lanes.  `offer` keeps the M
// polylines of smallest key, each at its smallest-key entry, whatever the
// order of the offers (keys are distinct: an arrival index names one
// entry).  Offered in increasing index, as one lane offers its entries,
// it decides exactly as TopM<M>::offer, whose strict `<` makes the
// earliest of equal distances win.  Empty slots hold (BIG, -1, -1), so a
// candidate at distance BIG never enters, as in TopM.  The winners'
// fields (seg, t, x, y) are recomputed from their entries at the end.
template <int M>
struct TopKey {
  float d[M];
  int idx[M];
  int pl[M];

  static __device__ __forceinline__ bool less(float d1, int i1, float d2,
                                              int i2) {
    return d1 < d2 || (d1 == d2 && i1 < i2);
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      d[i] = BIG;
      idx[i] = -1;
      pl[i] = -1;
    }
  }

  __device__ __forceinline__ void swap_down(int i) {  // swap i-1 <-> i
    float fd = d[i]; d[i] = d[i - 1]; d[i - 1] = fd;
    int ii = idx[i]; idx[i] = idx[i - 1]; idx[i - 1] = ii;
    int ip = pl[i]; pl[i] = pl[i - 1]; pl[i - 1] = ip;
  }

  // p >= 0
  __device__ __forceinline__ void offer(float dd, int ii, int p) {
    bool same = false;
    bool moved = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (pl[i] == p) {
        same = true;
        if (less(dd, ii, d[i], idx[i])) {
          d[i] = dd;
          idx[i] = ii;
          moved = true;
        }
      }
    }
    if (same && !moved) return;
    if (!same) {
      if (!less(dd, ii, d[M - 1], idx[M - 1])) return;
      d[M - 1] = dd;
      idx[M - 1] = ii;
      pl[M - 1] = p;
    }
#pragma unroll
    for (int i = M - 1; i > 0; --i) {
      if (less(d[i], idx[i], d[i - 1], idx[i - 1])) swap_down(i);
    }
  }

  // Merge the partial of the lane `off` lanes away (xor) in a group of
  // G lanes; after log2(G) rounds every lane of the group holds the
  // group's top-M.
  template <int G>
  __device__ __forceinline__ void merge_xor(int off) {
    float od[M];
    int oi[M], op[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      od[i] = __shfl_xor_sync(0xffffffffu, d[i], off, G);
      oi[i] = __shfl_xor_sync(0xffffffffu, idx[i], off, G);
      op[i] = __shfl_xor_sync(0xffffffffu, pl[i], off, G);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (op[i] >= 0) offer(od[i], oi[i], op[i]);
    }
  }
};

}  // namespace eg3d
