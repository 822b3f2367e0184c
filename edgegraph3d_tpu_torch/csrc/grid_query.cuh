// Per-query bodies of K1 grid_topm_query and K2 epipolar_topm_query,
// shared by those kernels and by K7 expand_chains, so every caller makes
// each decision with the same arithmetic in the same order.
#pragma once

#include "common.cuh"

namespace eg3d {

// K1's query: the 3x3 cells around (px, py) on view v (clipped at the
// image border, so border cells repeat exactly as the reference's gather
// does), 8 entries (pl, seg, ax, ay, bx, by) per cell, the point-segment
// distance, entries within `radius` offered to the top-M of distinct
// polylines.
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
      const float* e = grids + (((v * GH + yy) * GW + xx) * Kc) * 6;
      for (int k = 0; k < Kc; ++k, e += 6) {
        const int pl = (int)e[0];
        if (pl < 0) continue;
        const float ax = e[2], ay = e[3], bx = e[4], by = e[5];
        const float ux = bx - ax;
        const float uy = by - ay;
        const float denom = nmax(ux * ux + uy * uy, 1e-12f);
        const float t = clip01(((px - ax) * ux + (py - ay) * uy) / denom);
        const float qx = ax + t * ux;
        const float qy = ay + t * uy;
        const float dx = px - qx;
        const float dy = py - qy;
        const float d = sqrtf(dx * dx + dy * dy);
        if (d <= radius) top.offer(d, pl, (int)e[1], t, qx, qy);
      }
    }
  }
}

// K2's query: the 5x5 cells around the observation (ox, oy) on view v,
// every entry's segment intersected with the normalized line (l0, l1,
// l2), crossings within `rad` (optionally without quasi-parallel
// segments, |cos| >= excl_cos) offered to the top-M of distinct
// polylines.
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
      const float* e = grids + (((v * GH + yy) * GW + xx) * Kc) * 6;
      for (int k = 0; k < Kc; ++k, e += 6) {
        const int pl = (int)e[0];
        if (pl < 0) continue;
        const float ax = e[2], ay = e[3], bx = e[4], by = e[5];
        const float sa = ax * l0 + ay * l1 + l2;
        const float sb = bx * l0 + by * l1 + l2;
        const float diff = sa - sb;
        const bool parallel = fabsf(diff) < 1e-9f;
        const float s = parallel ? 0.0f : sa / diff;
        bool crosses = (sa * sb <= 0.0f) && !parallel && (s >= 0.0f) &&
                       (s <= 1.0f);
        const float abx = bx - ax;
        const float aby = by - ay;
        if (use_excl) {
          const float len = nmax(sqrtf(abx * abx + aby * aby), 1e-12f);
          const float c = fabsf(abx * (-l1) + aby * l0) / len;
          crosses = crosses && (c < excl_cos);
        }
        if (!crosses) continue;
        const float x = ax + s * abx;
        const float y = ay + s * aby;
        const float ex = x - ox;
        const float ey = y - oy;
        const float d = sqrtf(ex * ex + ey * ey);
        if (d <= rad) top.offer(d, pl, (int)e[1], s, x, y);
      }
    }
  }
}

}  // namespace eg3d
