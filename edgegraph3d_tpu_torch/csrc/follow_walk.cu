// K4 follow_walk — the bounded chain-following walk, one thread per lane.
//
// Replaces (JAX): the while_loop of edgegraph3d_tpu/matching/following.py
//   follow_seeds (body _walk_step) with ops/polyline_ops.py
//   advance_by_distance_xy, next_intersection_bounded_xy and
//   _segments_line_intersection_xy.  Also serves
//   resolve_configuration's 12 one-step trials (max_steps = 1).
//
// Each lane walks its own 3 polylines (driving view first, in the lane's
// permuted order), read straight from plg_coords [V, P, L, 2] — the work
// of the XLA gather that fed the JAX loop.  Per step:
//   1. advance `step` px along the driving polyline: the first segment in
//      walk order whose far end leaves the circle, then the circle-segment
//      root in the walk direction;
//   2. the two epipolar lines of the new point (F_table[cam0, cam1/2]),
//      normalized so a^2 + b^2 = 1;
//   3. on each other view, the first segment in walk order that carries a
//      crossing (beyond t on the current segment) or a quasi-parallel
//      line; a crossing is accepted only within [min_d, max_d] px.
// A lane stops at its first failure (JAX keeps stepping dead lanes until
// all are dead and writes their slots; only live slots carry meaning).
// Slots after a lane's death are written as zeros with alive = 0.
// The walk stays bounded by `T`; longer chains continue in the caller's
// continuation rounds.
//
// Bound on the H100: latency.  A step scans a few segments of three
// 64-point polylines (512 B each, L1-resident after the first touch) with
// data-dependent trip counts; lanes of a warp diverge in chain length.
// Outputs are T x 52 B per lane.

#include "common.cuh"

namespace {

// next_intersection_bounded_xy: returns found; writes seg/t/x/y.
__device__ __forceinline__ bool intersect(const eg3d::Poly& p, int seg, float t,
                                          float cx, float cy, int dir,
                                          float l0, float l1, float l2,
                                          float min_d, float max_d,
                                          float qcos, float qdist, int* nseg,
                                          float* nt, float* nx, float* ny) {
  const bool fwd = dir > 0;
  const int hi = p.len - 2;
  int j = fwd ? (seg < 0 ? 0 : seg) : (seg < hi ? seg : hi);
  for (; fwd ? (j <= hi) : (j >= 0); j += fwd ? 1 : -1) {
    const float ax = p.c[2 * j], ay = p.c[2 * j + 1];
    const float bx = p.c[2 * (j + 1)], by = p.c[2 * (j + 1) + 1];
    const eg3d::SegLine r =
        eg3d::seg_line(ax, ay, bx, by, l0, l1, l2, qcos, qdist);
    const float s = r.s;
    const bool s_ok = (j == seg) ? (fwd ? (s >= t) : (s <= t)) : true;
    if (r.quasi) return false;  // quasi-parallel event first: stop
    if (r.has && s_ok) {
      const float sx = ax + s * (bx - ax);
      const float sy = ay + s * (by - ay);
      const float ex = sx - cx;
      const float ey = sy - cy;
      const float dsq = ex * ex + ey * ey;
      *nseg = j;
      *nt = s;
      *nx = sx;
      *ny = sy;
      return (dsq >= min_d * min_d) && (dsq <= max_d * max_d);
    }
  }
  return false;  // reached the extreme
}

__global__ void follow_walk_kernel(
    const float* __restrict__ coords, const int* __restrict__ lengths, int P,
    int L, const float* __restrict__ F_table, int V,
    const int* __restrict__ cams, const int* __restrict__ pls,
    const int* __restrict__ seg0, const float* __restrict__ t0,
    const float* __restrict__ xy0, const int* __restrict__ dirs,
    const uint8_t* __restrict__ active0, int S, int T, float step,
    float min_d, float max_d, float qcos, float qdist, float* obs_out,
    int* seg_out, float* t_out, uint8_t* alive_out) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  eg3d::Poly poly[3];
  int seg[3], dir[3];
  float t[3], x[3], y[3];
  for (int k = 0; k < 3; ++k) {
    const int64_t cv = cams[3 * s + k];
    // a lane of an invalid seed may carry pl = -1 (no polyline located);
    // resolve_configuration still walks it, so the id wraps as the plain
    // twin's torch index does (-1 -> the view's last polyline) instead of
    // reading before the table
    const int64_t pl = pls[3 * s + k] < 0 ? pls[3 * s + k] + P : pls[3 * s + k];
    poly[k].c = coords + (cv * P + pl) * L * 2;
    poly[k].len = lengths[cv * P + pl];
    seg[k] = seg0[3 * s + k];
    t[k] = t0[3 * s + k];
    x[k] = xy0[6 * s + 2 * k];
    y[k] = xy0[6 * s + 2 * k + 1];
    dir[k] = dirs[3 * s + k];
  }
  const float* F1 = F_table + ((int64_t)cams[3 * s] * V + cams[3 * s + 1]) * 9;
  const float* F2 = F_table + ((int64_t)cams[3 * s] * V + cams[3 * s + 2]) * 9;
  bool active = active0[s] != 0;
  for (int i = 0; i < T; ++i) {
    const int64_t o = s * T + i;
    int ns[3] = {0, 0, 0};
    float nt[3] = {0.f, 0.f, 0.f}, nx[3] = {0.f, 0.f, 0.f},
          ny[3] = {0.f, 0.f, 0.f};
    bool ok = false;
    if (active) {
      ok = eg3d::advance(poly[0], seg[0], x[0], y[0], dir[0], step, &ns[0], &nt[0],
                   &nx[0], &ny[0]);
      for (int k = 1; k < 3 && ok; ++k) {
        const float* F = (k == 1) ? F1 : F2;
        float l0, l1, l2;
        eg3d::epipolar(F, nx[0], ny[0], &l0, &l1, &l2);
        ok = intersect(poly[k], seg[k], t[k], x[k], y[k], dir[k], l0, l1, l2,
                       min_d, max_d, qcos, qdist, &ns[k], &nt[k], &nx[k],
                       &ny[k]);
      }
    }
    active = active && ok;
    if (!active) {
      for (int k = 0; k < 3; ++k) { ns[k] = 0; nt[k] = 0.f; nx[k] = 0.f; ny[k] = 0.f; }
    } else {
      for (int k = 0; k < 3; ++k) {
        seg[k] = ns[k];
        t[k] = nt[k];
        x[k] = nx[k];
        y[k] = ny[k];
      }
    }
    for (int k = 0; k < 3; ++k) {
      obs_out[6 * o + 2 * k] = nx[k];
      obs_out[6 * o + 2 * k + 1] = ny[k];
      seg_out[3 * o + k] = ns[k];
      t_out[3 * o + k] = nt[k];
    }
    alive_out[o] = active ? 1 : 0;
  }
}

}  // namespace

extern "C" int eg3d_follow_walk(const float* coords, const int* lengths, int V,
                                int P, int L, const float* F_table,
                                const int* cams, const int* pls,
                                const int* seg0, const float* t0,
                                const float* xy0, const int* dirs,
                                const uint8_t* active0, int S, int T,
                                float step, float min_d, float max_d,
                                float qcos, float qdist, float* obs, int* seg,
                                float* t, uint8_t* alive, void* stream) {
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  follow_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coords, lengths, P, L, F_table, V, cams, pls, seg0, t0, xy0, dirs,
      active0, S, T, step, min_d, max_d, qcos, qdist, obs, seg, t, alive);
  return (int)cudaGetLastError();
}
