// K4 follow_walk — chain following with its GN acceptance, one thread
// per seed lane at a time, lanes refilled from a global counter.
//
// Replaces (JAX): edgegraph3d_tpu/matching/following.py follow_seeds —
//   the while_loop (body _walk_step: ops/polyline_ops.py
//   advance_by_distance_xy, next_intersection_bounded_xy and
//   _segments_line_intersection_xy), the compacted post-walk DLT + GN
//   (triangulate_dlt_soa, gauss_newton_soa) and the prefix cut at the
//   first GN failure — and resolve_configuration's 12 one-step trials
//   (_one_step, GN warm-started from the seed).
//
// Each lane walks its own 3 polylines (driving view first, in the lane's
// permuted order), read straight from plg_coords [V, P, L, 2].  Per step:
//   1. advance `step` px along the driving polyline: the first segment in
//      walk order whose far end leaves the circle, then the circle-segment
//      root in the walk direction, with the multiply-adds XLA's CPU code
//      fuses in the JAX loop (common.cuh advance);
//   2. the two epipolar lines of the new point (F_table[cam0, cam1/2]),
//      normalized so a^2 + b^2 = 1;
//   3. on each other view, the first segment in walk order that carries a
//      crossing (beyond t on the current segment) or a quasi-parallel
//      line; a crossing is accepted only within [min_d, max_d] px;
//   4. the three new observations triangulated with gn.cuh: cold (X0
//      null) DLT then gn_iters GN iterations; warm, GN from the lane's X0.
//      The step is accepted when the GN point is valid.
// The chain ends at its first failure or after T steps.  The reference
// triangulates every step inside its walk (plg_matching.cpp:633-759);
// the JAX package hoisted the GN out of the loop for the TPU, which
// changes no result, since the walk does not depend on the GN.
//
// Outputs (zero-filled by the wrapper): per accepted step valid = 1, X,
// obs, seg, t; the step whose GN failed keeps its walk observation, seg
// and t with valid = 0 (pack_follow_outputs reads obs[:, 0] of a seed
// with no accepted step); n_steps, and final_seg / final_t = the last
// accepted position (the start when none).
//
// Designed for the H100:
//   * lane refill: chain lengths run from 0 to T, so a thread whose chain
//     ends takes the next seed from a counter (a warp-aggregated
//     atomicAdd) within the same step loop, and a warp does not wait for
//     its longest chain.  The grid is a few blocks per SM.  Each seed
//     writes only its own slots, so the order changes no output;
//   * a seed's 3 x 12 floats of P and its two F matrices stay in
//     registers for the whole walk (gn.cuh LocalObs).
//
// Bound on the H100: latency of the sequential steps (a few segment tests
// of three 64-point polylines, then a DLT and up to gn_iters GN
// iterations), with data-dependent trip counts.

#include "gn.cuh"

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

struct Args {
  const float* coords;
  const int* lengths;
  int P, L;
  const float* F_table;
  int V;
  const float* P_mats;
  const int* cams;
  const int* pls;
  const int* seg0;
  const float* t0;
  const float* xy0;
  const int* dirs;
  const uint8_t* active0;
  const float* X0;  // null: cold GN (DLT first)
  int S, T;
  float step, min_d, max_d, qcos, qdist;
  int gn_iters;
  float epsilon, accept_mse, det_min;
  int* counter;
  uint8_t* valid;
  int* n_steps;
  float* X;
  float* obs;
  int* seg;
  float* t;
  int* final_seg;
  float* final_t;
};

// The next seed for the calling thread from the counter (zeroed by the
// wrapper): one atomicAdd per group of threads that ask together, each
// taking its rank in the group.
__device__ __forceinline__ int grab(int* counter) {
  const unsigned group = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(group) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(group));
  base = __shfl_sync(group, base, leader);
  return base + __popc(group & ((1u << lane) - 1));
}

// One lane's walk state: the seed's polylines, position and matrices.
struct Lane {
  int64_t s;
  eg3d::Poly poly[3];
  int seg[3], dir[3];
  float t[3], x[3], y[3];
  float F1[9], F2[9];
  eg3d::LocalObs<3> ob;  // P rows of the 3 cameras; points set per step
  int i;                 // next step
  bool active;

  __device__ __forceinline__ void load(const Args& a, int64_t seed) {
    s = seed;
    int c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = a.cams[3 * s + k];
      // a lane of an invalid seed may carry pl = -1 (no polyline
      // located); resolve_configuration still walks it, so the id wraps
      // as the plain twin's torch index does (-1 -> the view's last
      // polyline) instead of reading before the table
      const int64_t pl = a.pls[3 * s + k] < 0 ? a.pls[3 * s + k] + a.P
                                              : a.pls[3 * s + k];
      poly[k].c = a.coords + ((int64_t)c[k] * a.P + pl) * a.L * 2;
      poly[k].len = a.lengths[(int64_t)c[k] * a.P + pl];
      seg[k] = a.seg0[3 * s + k];
      t[k] = a.t0[3 * s + k];
      x[k] = a.xy0[6 * s + 2 * k];
      y[k] = a.xy0[6 * s + 2 * k + 1];
      dir[k] = a.dirs[3 * s + k];
      const float* p = a.P_mats + (int64_t)c[k] * 12;
#pragma unroll
      for (int q = 0; q < 12; ++q) ob.P[12 * k + q] = p[q];
      ob.m[k] = 1.0f;
    }
    const float* f1 = a.F_table + ((int64_t)c[0] * a.V + c[1]) * 9;
    const float* f2 = a.F_table + ((int64_t)c[0] * a.V + c[2]) * 9;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      F1[q] = f1[q];
      F2[q] = f2[q];
    }
    i = 0;
    active = a.active0[s] != 0 && a.T > 0;
  }

  // One step: walk, then triangulate.  Returns whether the chain goes on.
  __device__ __forceinline__ bool step(const Args& a) {
    int ns[3];
    float nt[3], nx[3], ny[3];
    bool ok = eg3d::advance(poly[0], seg[0], x[0], y[0], dir[0], a.step,
                            &ns[0], &nt[0], &nx[0], &ny[0]);
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      if (!ok) break;
      float l0, l1, l2;
      eg3d::epipolar(k == 1 ? F1 : F2, nx[0], ny[0], &l0, &l1, &l2);
      ok = intersect(poly[k], seg[k], t[k], x[k], y[k], dir[k], l0, l1, l2,
                     a.min_d, a.max_d, a.qcos, a.qdist, &ns[k], &nt[k],
                     &nx[k], &ny[k]);
    }
    if (!ok) return false;
    const int64_t o = s * a.T + i;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.obs[6 * o + 2 * k] = nx[k];
      a.obs[6 * o + 2 * k + 1] = ny[k];
      a.seg[3 * o + k] = ns[k];
      a.t[3 * o + k] = nt[k];
      ob.x[k] = nx[k];
      ob.y[k] = ny[k];
    }
    float X, Y, Z;
    if (a.X0 != nullptr) {
      X = a.X0[3 * s];
      Y = a.X0[3 * s + 1];
      Z = a.X0[3 * s + 2];
    } else {
      eg3d::dlt(ob.P, ob, 3, &X, &Y, &Z);
    }
    const eg3d::GNResult r =
        eg3d::gauss_newton(ob.P, ob, 3, 3.0f, X, Y, Z, a.gn_iters,
                           a.epsilon, a.accept_mse, a.det_min);
    if (!r.valid) return false;
    a.valid[o] = 1;
    a.X[3 * o] = r.x;
    a.X[3 * o + 1] = r.y;
    a.X[3 * o + 2] = r.z;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      seg[k] = ns[k];
      t[k] = nt[k];
      x[k] = nx[k];
      y[k] = ny[k];
    }
    ++i;
    return i < a.T;
  }

  __device__ __forceinline__ void finish(const Args& a) const {
    a.n_steps[s] = i;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.final_seg[3 * s + k] = seg[k];
      a.final_t[3 * s + k] = t[k];
    }
  }
};

__global__ void follow_walk_kernel(Args a) {
  Lane lane;
  int s = grab(a.counter);
  if (s < a.S) lane.load(a, s);
  while (s < a.S) {
    lane.active = lane.active && lane.step(a);
    if (!lane.active) {
      lane.finish(a);
      s = grab(a.counter);
      if (s < a.S) lane.load(a, s);
    }
  }
}

// A few blocks per SM (fewer when the seeds do not fill them): the
// threads refill until the counter passes S.
int blocks_for(int S, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int need = (S + threads - 1) / threads;
  return need < 4 * sms ? need : 4 * sms;
}

}  // namespace

extern "C" int eg3d_follow_walk(
    const float* coords, const int* lengths, int V, int P, int L,
    const float* F_table, const float* P_mats, const int* cams,
    const int* pls, const int* seg0, const float* t0, const float* xy0,
    const int* dirs, const uint8_t* active0, const float* X0, int S, int T,
    float step, float min_d, float max_d, float qcos, float qdist,
    int gn_iters, float epsilon, float accept_mse, float det_min,
    int* counter, uint8_t* valid, int* n_steps, float* X, float* obs,
    int* seg, float* t, int* final_seg, float* final_t, void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  const Args a{coords, lengths, P, L, F_table, V, P_mats, cams, pls, seg0,
               t0, xy0, dirs, active0, X0, S, T, step, min_d, max_d, qcos,
               qdist, gn_iters, epsilon, accept_mse, det_min, counter, valid,
               n_steps, X, obs, seg, t, final_seg, final_t};
  const int threads = 128;
  follow_walk_kernel<<<blocks_for(S, threads), threads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
