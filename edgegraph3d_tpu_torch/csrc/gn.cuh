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
#pragma once

#include "common.cuh"

namespace eg3d {

// ops.triangulation.triangulate_dlt_soa for one point: A^T A from the
// row-normalized DLT rows (x P3 - P1, y P3 - P2 per observation, each
// scaled to unit norm times its weight), ridge 1e-7 * trace, closed-form
// 4x4 Cholesky, 4 rounds of inverse iteration from (1, 1, 1, 1.5) / |.|.
template <class Tab, class Obs>
__device__ __forceinline__ void dlt(const Tab P_mats,
                                    const Obs& obs, int O, float* X,
                                    float* Y, float* Z) {
  float a00 = 0.f, a01 = 0.f, a02 = 0.f, a03 = 0.f, a11 = 0.f, a12 = 0.f,
        a13 = 0.f, a22 = 0.f, a23 = 0.f, a33 = 0.f;
  for (int o = 0; o < O; ++o) {
    int cam;
    float ox, oy, m;
    obs(o, &cam, &ox, &oy, &m);
    const auto p = P_mats + (int64_t)cam * 12;
    for (int prow = 0; prow < 2; ++prow) {
      const float coord = prow == 0 ? ox : oy;
      float r0 = coord * p[8] - p[4 * prow + 0];
      float r1 = coord * p[9] - p[4 * prow + 1];
      float r2 = coord * p[10] - p[4 * prow + 2];
      float r3 = coord * p[11] - p[4 * prow + 3];
      const float nrm = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + r3 * r3);
      const float scale = m / nmax(nrm, 1e-12f);
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
  const float tr = a00 + a11 + a22 + a33;
  const float eps = 1e-7f * tr + 1e-30f;
  a00 = a00 + eps; a11 = a11 + eps; a22 = a22 + eps; a33 = a33 + eps;
  const float L11 = sqrtf(nmax(a00, 1e-30f));
  const float L21 = a01 / L11;
  const float L31 = a02 / L11;
  const float L41 = a03 / L11;
  const float L22 = sqrtf(nmax(a11 - L21 * L21, 1e-30f));
  const float L32 = (a12 - L31 * L21) / L22;
  const float L42 = (a13 - L41 * L21) / L22;
  const float L33 = sqrtf(nmax(a22 - L31 * L31 - L32 * L32, 1e-30f));
  const float L43 = (a23 - L41 * L31 - L42 * L32) / L33;
  const float L44 =
      sqrtf(nmax(a33 - L41 * L41 - L42 * L42 - L43 * L43, 1e-30f));
  const double nv = sqrt(1.0 + 1.0 + 1.0 + 1.5 * 1.5);
  float v0 = (float)(1.0 / nv), v1 = v0, v2 = v0, v3 = (float)(1.5 / nv);
  for (int it = 0; it < 4; ++it) {
    const float y1 = v0 / L11;
    const float y2 = (v1 - L21 * y1) / L22;
    const float y3 = (v2 - L31 * y1 - L32 * y2) / L33;
    const float y4 = (v3 - L41 * y1 - L42 * y2 - L43 * y3) / L44;
    const float x4 = y4 / L44;
    const float x3 = (y3 - L43 * x4) / L33;
    const float x2 = (y2 - L32 * x3 - L42 * x4) / L22;
    const float x1 = (y1 - L21 * x2 - L31 * x3 - L41 * x4) / L11;
    const float nn =
        nmax(sqrtf(x1 * x1 + x2 * x2 + x3 * x3 + x4 * x4), 1e-30f);
    v0 = x1 / nn;
    v1 = x2 / nn;
    v2 = x3 / nn;
    v3 = x4 / nn;
  }
  const float w = (fabsf(v3) < 1e-12f) ? ((v3 < 0.0f) ? -1e-12f : 1e-12f) : v3;
  *X = v0 / w;
  *Y = v1 / w;
  *Z = v2 / w;
}

// The observations of one point held in registers: N cameras' P rows
// copied into a local [N, 3, 4] table (pass it as P_mats; observation o
// is camera o), points and weights.  With N a compile-time constant and
// dlt / gauss_newton inlined, every index is a constant, so the GN loop
// does no memory loads.
template <int N>
struct LocalObs {
  float P[N * 12];
  float x[N], y[N], m[N];
  __device__ __forceinline__ void operator()(int o, int* c, float* ox,
                                             float* oy, float* w) const {
    *c = o;
    *ox = x[o];
    *oy = y[o];
    *w = m[o];
  }
};

struct GNResult {
  float x, y, z;
  float mse;   // last_mse
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
template <class Tab, class Obs>
__device__ __forceinline__ GNResult gauss_newton(
    const Tab P_mats, const Obs& obs, int O, float mask_sum,
    float x, float y, float z, int max_iters, float epsilon,
    float accept_mse, float det_min) {
  const float n_obs = nmax(mask_sum, 1.0f);
  float last_mse = 0.0f;
  bool frozen = false, singular = false;
  for (int it = 0; it < max_iters && !(frozen || singular); ++it) {
    float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, sq = 0.f;
    for (int o = 0; o < O; ++o) {
      int cam;
      float ox, oy, m;
      obs(o, &cam, &ox, &oy, &m);
      const auto p = P_mats + (int64_t)cam * 12;
      const float xH = p[0] * x + p[1] * y + p[2] * z + p[3];
      const float yH = p[4] * x + p[5] * y + p[6] * z + p[7];
      float zH = p[8] * x + p[9] * y + p[10] * z + p[11];
      zH = (fabsf(zH) < 1e-12f) ? ((zH < 0.0f) ? -1e-12f : 1e-12f) : zH;
      const float rx = (ox - xH / zH) * m;
      const float ry = (oy - yH / zH) * m;
      sq = sq + rx * rx + ry * ry;
      const float inv_z2 = m / (zH * zH);
      const float jx0 = (p[0] * zH - p[8] * xH) * inv_z2;
      const float jx1 = (p[1] * zH - p[9] * xH) * inv_z2;
      const float jx2 = (p[2] * zH - p[10] * xH) * inv_z2;
      const float jy0 = (p[4] * zH - p[8] * yH) * inv_z2;
      const float jy1 = (p[5] * zH - p[9] * yH) * inv_z2;
      const float jy2 = (p[6] * zH - p[10] * yH) * inv_z2;
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
    const float mse = sq / (2.0f * n_obs);
    const bool conv = fabsf(mse - last_mse) < epsilon;
    const bool now_frozen = frozen || conv;
    const float c00 = h11 * h22 - h12 * h12;
    const float c01 = h02 * h12 - h01 * h22;
    const float c02 = h01 * h12 - h02 * h11;
    const float det = h00 * c00 + h01 * c01 + h02 * c02;
    const float c11 = h00 * h22 - h02 * h02;
    const float c12 = h01 * h02 - h00 * h12;
    const float c22 = h00 * h11 - h01 * h01;
    const float safe =
        (fabsf(det) < 1e-20f) ? ((det < 0.0f) ? -1e-20f : 1e-20f) : det;
    const float dx = (c00 * g0 + c01 * g1 + c02 * g2) / safe;
    const float dy = (c01 * g0 + c11 * g1 + c12 * g2) / safe;
    const float dz = (c02 * g0 + c12 * g1 + c22 * g2) / safe;
    const float h_sq = h00 * h00 + h11 * h11 + h22 * h22 +
                       2.0f * (h01 * h01 + h02 * h02 + h12 * h12);
    const float h_scale = sqrtf(h_sq / 3.0f);
    const bool bad = (fabsf(det) < det_min) ||
                     (fabsf(det) < 1e-5f * (h_scale * (h_scale * h_scale)));
    if (!(now_frozen || bad)) {
      x = x + dx;
      y = y + dy;
      z = z + dz;
    }
    if (!now_frozen) last_mse = mse;
    singular = singular || (bad && !now_frozen);
    frozen = now_frozen;
  }
  GNResult r;
  r.x = x;
  r.y = y;
  r.z = z;
  r.mse = last_mse;
  r.valid = !singular && (last_mse < accept_mse) && (mask_sum >= 2.0f);
  return r;
}

}  // namespace eg3d
