// The DLT initialisation and the Gauss-Newton refinement of one point,
// shared by K3 triangulate_gn, K4 follow_walk (the GN acceptance of each
// step) and K7 expand_chains, so all make each decision with the same
// arithmetic in the same order.
//
// Both take the camera table P_mats [V, 3, 4] as a pointer (shared memory,
// registers) or a common.cuh Ldg (device memory), and an observation
// accessor `obs(o, &cam, &ox, &oy, &m)`:
// observation o's camera index into P_mats [V, 3, 4], its image point and
// its weight (0 or 1; a 0 adds exact zeros while its intermediates stay
// finite).  Both visit o = 0, 1, ..., O - 1 in order in every pass.
// Both are templates on the compute scalar T (float, or double for the
// f64 bodies; common.cuh): the table's entries, the points, the weights
// and every intermediate are T.
#pragma once

#include "common.cuh"

namespace eg3d {

// ops.triangulation.triangulate_dlt_soa for one point: A^T A from the
// row-normalized DLT rows (x P3 - P1, y P3 - P2 per observation, each
// scaled to unit norm times its weight), ridge 1e-7 * trace, closed-form
// 4x4 Cholesky, 4 rounds of inverse iteration from (1, 1, 1, 1.5) / |.|.
template <class T, class Tab, class Obs>
__device__ __forceinline__ void dlt(const Tab P_mats, const Obs& obs, int O,
                                    T* X, T* Y, T* Z) {
  T a00 = T(0), a01 = T(0), a02 = T(0), a03 = T(0), a11 = T(0), a12 = T(0),
    a13 = T(0), a22 = T(0), a23 = T(0), a33 = T(0);
  for (int o = 0; o < O; ++o) {
    int cam;
    T ox, oy, m;
    obs(o, &cam, &ox, &oy, &m);
    const auto p = P_mats + (int64_t)cam * 12;
    for (int prow = 0; prow < 2; ++prow) {
      const T coord = prow == 0 ? ox : oy;
      T r0 = coord * p[8] - p[4 * prow + 0];
      T r1 = coord * p[9] - p[4 * prow + 1];
      T r2 = coord * p[10] - p[4 * prow + 2];
      T r3 = coord * p[11] - p[4 * prow + 3];
      const T nrm = vsqrt(r0 * r0 + r1 * r1 + r2 * r2 + r3 * r3);
      const T scale = m / nmax(nrm, T(1e-12));
      r0 = r0 * scale;
      r1 = r1 * scale;
      r2 = r2 * scale;
      r3 = r3 * scale;
      a00 = a00 + r0 * r0; a01 = a01 + r0 * r1; a02 = a02 + r0 * r2;
      a03 = a03 + r0 * r3; a11 = a11 + r1 * r1; a12 = a12 + r1 * r2;
      a13 = a13 + r1 * r3; a22 = a22 + r2 * r2; a23 = a23 + r2 * r3;
      a33 = a33 + r3 * r3;
    }
  }
  const T tr = a00 + a11 + a22 + a33;
  const T eps = T(1e-7) * tr + T(1e-30);
  a00 = a00 + eps; a11 = a11 + eps; a22 = a22 + eps; a33 = a33 + eps;
  const T L11 = vsqrt(nmax(a00, T(1e-30)));
  const T L21 = a01 / L11;
  const T L31 = a02 / L11;
  const T L41 = a03 / L11;
  const T L22 = vsqrt(nmax(a11 - L21 * L21, T(1e-30)));
  const T L32 = (a12 - L31 * L21) / L22;
  const T L42 = (a13 - L41 * L21) / L22;
  const T L33 = vsqrt(nmax(a22 - L31 * L31 - L32 * L32, T(1e-30)));
  const T L43 = (a23 - L41 * L31 - L42 * L32) / L33;
  const T L44 = vsqrt(nmax(a33 - L41 * L41 - L42 * L42 - L43 * L43,
                           T(1e-30)));
  const double nv = sqrt(1.0 + 1.0 + 1.0 + 1.5 * 1.5);
  T v0 = (T)(1.0 / nv), v1 = v0, v2 = v0, v3 = (T)(1.5 / nv);
  for (int it = 0; it < 4; ++it) {
    const T y1 = v0 / L11;
    const T y2 = (v1 - L21 * y1) / L22;
    const T y3 = (v2 - L31 * y1 - L32 * y2) / L33;
    const T y4 = (v3 - L41 * y1 - L42 * y2 - L43 * y3) / L44;
    const T x4 = y4 / L44;
    const T x3 = (y3 - L43 * x4) / L33;
    const T x2 = (y2 - L32 * x3 - L42 * x4) / L22;
    const T x1 = (y1 - L21 * x2 - L31 * x3 - L41 * x4) / L11;
    const T nn = nmax(vsqrt(x1 * x1 + x2 * x2 + x3 * x3 + x4 * x4),
                      T(1e-30));
    v0 = x1 / nn;
    v1 = x2 / nn;
    v2 = x3 / nn;
    v3 = x4 / nn;
  }
  const T w =
      (vabs(v3) < T(1e-12)) ? ((v3 < T(0)) ? T(-1e-12) : T(1e-12)) : v3;
  *X = v0 / w;
  *Y = v1 / w;
  *Z = v2 / w;
}

// The observations of one point held in registers: N cameras' P rows
// copied into a local [N, 3, 4] table (pass it as P_mats; observation o
// is camera o), points and weights.  With N a compile-time constant and
// dlt / gauss_newton inlined, every index is a constant, so the GN loop
// does no memory loads.
template <int N, class T = float>
struct LocalObs {
  T P[N * 12];
  T x[N], y[N], m[N];
  __device__ __forceinline__ void operator()(int o, int* c, T* ox, T* oy,
                                             T* w) const {
    *c = o;
    *ox = x[o];
    *oy = y[o];
    *w = m[o];
  }
};

template <class T>
struct GNResult {
  T x, y, z;
  T mse;       // last_mse
  bool valid;  // !singular && last_mse < accept_mse && mask_sum >= 2
};

// Up to max_iters steps of the 3x3 Cramer solve from (x, y, z) over O
// observations.  `obs(o, &cam, &ox, &oy, &m)` yields observation o: its
// camera index into P_mats [V, 3, 4], its image point and its weight
// (0 or 1; a 0 adds exact zeros).  A point stops when it freezes (|mse -
// last_mse| < epsilon) or turns singular (absolute and scale-relative
// det guards); the reference keeps iterating such points as no-ops, so
// stopping early is exact.  last_mse is updated only on non-frozen
// iterations, as in the reference.
template <class T, class Tab, class Obs>
__device__ __forceinline__ GNResult<T> gauss_newton(
    const Tab P_mats, const Obs& obs, int O, T mask_sum, T x, T y, T z,
    int max_iters, T epsilon, T accept_mse, T det_min) {
  const T n_obs = nmax(mask_sum, T(1));
  T last_mse = T(0);
  bool frozen = false, singular = false;
  for (int it = 0; it < max_iters && !(frozen || singular); ++it) {
    T h00 = T(0), h01 = T(0), h02 = T(0), h11 = T(0), h12 = T(0),
      h22 = T(0);
    T g0 = T(0), g1 = T(0), g2 = T(0), sq = T(0);
    for (int o = 0; o < O; ++o) {
      int cam;
      T ox, oy, m;
      obs(o, &cam, &ox, &oy, &m);
      const auto p = P_mats + (int64_t)cam * 12;
      const T xH = p[0] * x + p[1] * y + p[2] * z + p[3];
      const T yH = p[4] * x + p[5] * y + p[6] * z + p[7];
      T zH = p[8] * x + p[9] * y + p[10] * z + p[11];
      zH = (vabs(zH) < T(1e-12)) ? ((zH < T(0)) ? T(-1e-12) : T(1e-12)) : zH;
      const T rx = (ox - xH / zH) * m;
      const T ry = (oy - yH / zH) * m;
      sq = sq + rx * rx + ry * ry;
      const T inv_z2 = m / (zH * zH);
      const T jx0 = (p[0] * zH - p[8] * xH) * inv_z2;
      const T jx1 = (p[1] * zH - p[9] * xH) * inv_z2;
      const T jx2 = (p[2] * zH - p[10] * xH) * inv_z2;
      const T jy0 = (p[4] * zH - p[8] * yH) * inv_z2;
      const T jy1 = (p[5] * zH - p[9] * yH) * inv_z2;
      const T jy2 = (p[6] * zH - p[10] * yH) * inv_z2;
      g0 = g0 + jx0 * rx + jy0 * ry;
      g1 = g1 + jx1 * rx + jy1 * ry;
      g2 = g2 + jx2 * rx + jy2 * ry;
      h00 = h00 + jx0 * jx0 + jy0 * jy0;
      h01 = h01 + jx0 * jx1 + jy0 * jy1;
      h02 = h02 + jx0 * jx2 + jy0 * jy2;
      h11 = h11 + jx1 * jx1 + jy1 * jy1;
      h12 = h12 + jx1 * jx2 + jy1 * jy2;
      h22 = h22 + jx2 * jx2 + jy2 * jy2;
    }
    const T mse = sq / (T(2) * n_obs);
    const bool conv = vabs(mse - last_mse) < epsilon;
    const bool now_frozen = frozen || conv;
    const T c00 = h11 * h22 - h12 * h12;
    const T c01 = h02 * h12 - h01 * h22;
    const T c02 = h01 * h12 - h02 * h11;
    const T det = h00 * c00 + h01 * c01 + h02 * c02;
    const T c11 = h00 * h22 - h02 * h02;
    const T c12 = h01 * h02 - h00 * h12;
    const T c22 = h00 * h11 - h01 * h01;
    const T safe =
        (vabs(det) < T(1e-20)) ? ((det < T(0)) ? T(-1e-20) : T(1e-20)) : det;
    const T dx = (c00 * g0 + c01 * g1 + c02 * g2) / safe;
    const T dy = (c01 * g0 + c11 * g1 + c12 * g2) / safe;
    const T dz = (c02 * g0 + c12 * g1 + c22 * g2) / safe;
    const T h_sq = h00 * h00 + h11 * h11 + h22 * h22 +
                   T(2) * (h01 * h01 + h02 * h02 + h12 * h12);
    const T h_scale = vsqrt(h_sq / T(3));
    const bool bad = (vabs(det) < det_min) ||
                     (vabs(det) < T(1e-5) * (h_scale * (h_scale * h_scale)));
    if (!(now_frozen || bad)) {
      x = x + dx;
      y = y + dy;
      z = z + dz;
    }
    if (!now_frozen) last_mse = mse;
    singular = singular || (bad && !now_frozen);
    frozen = now_frozen;
  }
  GNResult<T> r;
  r.x = x;
  r.y = y;
  r.z = z;
  r.mse = last_mse;
  r.valid = !singular && (last_mse < accept_mse) && (mask_sum >= T(2));
  return r;
}

}  // namespace eg3d
