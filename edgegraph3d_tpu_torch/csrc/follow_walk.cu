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

struct Poly {
  const float* c;  // [L, 2]
  int len;
};

// advance_by_distance_xy: returns found; writes seg/t/x/y.
__device__ __forceinline__ bool advance(const Poly& p, int seg, float cx,
                                        float cy, int dir, float radius,
                                        int* nseg, float* nt, float* nx,
                                        float* ny) {
  const float r2 = radius * radius;
  const bool fwd = dir > 0;
  int k = -1;
  if (fwd) {
    for (int j = seg < 0 ? 0 : seg; j < p.len - 1; ++j) {
      const float fx = p.c[2 * (j + 1)] - cx;
      const float fy = p.c[2 * (j + 1) + 1] - cy;
      if (fx * fx + fy * fy >= r2) { k = j; break; }
    }
  } else {
    for (int j = (seg < p.len - 2 ? seg : p.len - 2); j >= 0; --j) {
      const float fx = p.c[2 * j] - cx;
      const float fy = p.c[2 * j + 1] - cy;
      if (fx * fx + fy * fy >= r2) { k = j; break; }
    }
  }
  if (k < 0) return false;
  const float ax = p.c[2 * k], ay = p.c[2 * k + 1];
  const float ux = p.c[2 * (k + 1)] - ax;
  const float uy = p.c[2 * (k + 1) + 1] - ay;
  const float fx = ax - cx;
  const float fy = ay - cy;
  const float A = eg3d::nmax(ux * ux + uy * uy, 1e-12f);
  const float B = 2.0f * (ux * fx + uy * fy);
  const float C = fx * fx + fy * fy - r2;
  const float disc = eg3d::nmax(B * B - 4.0f * A * C, 0.0f);
  const float sq = sqrtf(disc);
  float s = fwd ? (-B + sq) / (2.0f * A) : (-B - sq) / (2.0f * A);
  s = eg3d::clip01(s);
  *nseg = k;
  *nt = s;
  *nx = ax + s * ux;
  *ny = ay + s * uy;
  return true;
}

// next_intersection_bounded_xy: returns found; writes seg/t/x/y.
__device__ __forceinline__ bool intersect(const Poly& p, int seg, float t,
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
    const float sa = ax * l0 + ay * l1 + l2;
    const float sb = bx * l0 + by * l1 + l2;
    const float diff = sa - sb;
    const bool crosses = (sa * sb) <= 0.0f;
    const bool parallel = fabsf(diff) < 1e-9f;
    const float s = parallel ? 0.0f : sa / diff;
    const float ux = bx - ax;
    const float uy = by - ay;
    const float ulen = eg3d::nmax(sqrtf(ux * ux + uy * uy), 1e-12f);
    const float c = fabsf(-ux * l1 + uy * l0) / ulen;
    const bool near = eg3d::nmin(fabsf(sa), fabsf(sb)) <= qdist;
    const bool quasi = (c > qcos) && near;
    const bool has = crosses && !parallel && !quasi;
    const bool s_ok = (j == seg) ? (fwd ? (s >= t) : (s <= t)) : true;
    if (quasi) return false;  // quasi-parallel event first: stop
    if (has && s_ok) {
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
  Poly poly[3];
  int seg[3], dir[3];
  float t[3], x[3], y[3];
  for (int k = 0; k < 3; ++k) {
    const int64_t cv = cams[3 * s + k];
    const int64_t pl = pls[3 * s + k];
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
      ok = advance(poly[0], seg[0], x[0], y[0], dir[0], step, &ns[0], &nt[0],
                   &nx[0], &ny[0]);
      for (int k = 1; k < 3 && ok; ++k) {
        const float* F = (k == 1) ? F1 : F2;
        float l0 = F[0] * nx[0] + F[1] * ny[0] + F[2];
        float l1 = F[3] * nx[0] + F[4] * ny[0] + F[5];
        float l2 = F[6] * nx[0] + F[7] * ny[0] + F[8];
        const float ln = eg3d::nmax(sqrtf(l0 * l0 + l1 * l1), 1e-20f);
        l0 = l0 / ln;
        l1 = l1 / ln;
        l2 = l2 / ln;
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
