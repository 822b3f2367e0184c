// The Gauss-Newton refinement of one point, shared by K3 triangulate_gn
// and K7 expand_chains, so both make each decision with the same
// arithmetic in the same order.
#pragma once

#include "common.cuh"

namespace eg3d {

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
template <class Obs>
__device__ __forceinline__ GNResult gauss_newton(
    const float* __restrict__ P_mats, const Obs& obs, int O, float mask_sum,
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
      const float* p = P_mats + (int64_t)cam * 12;
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
