// K3 triangulate_gn — N-view DLT init + per-point Gauss-Newton.
//
// Replaces (JAX): edgegraph3d_tpu/ops/triangulation.py
//   triangulate_dlt_soa and gauss_newton_soa (and their tensor wrappers
//   triangulate_dlt / gauss_newton_batched), as called by
//   refpoints._seed_from_starts, following.follow_seeds (post-walk GN),
//   following.resolve_configuration (warm start), the per-view GN of
//   expansion.expand_chains_compact and outliers.gauss_newton_filter.
//
// One thread per point, all state in registers.  Cameras come as an
// index [N, O] into P_mats [V, 3, 4] (never a materialized [N, O, 3, 4]).
//   * DLT (when X0 is null): A^T A from the row-normalized DLT rows,
//     ridge 1e-7 * trace, closed-form 4x4 Cholesky, 4 rounds of inverse
//     iteration from (1, 1, 1, 1.5) / |.|.
//   * GN: up to max_iters steps of the 3x3 Cramer solve.  A point stops
//     when it freezes (|mse - last_mse| < epsilon) or turns singular
//     (absolute and scale-relative det guards); the JAX loop keeps
//     iterating such points as no-ops until every point is done, so
//     stopping the thread early is exact.  valid = !singular &&
//     last_mse < accept_mse && sum(mask) >= 2, with last_mse updated
//     only on non-frozen iterations, as in the reference.
// Masked observations go through the same arithmetic with weight 0
// (they add exact zeros), so the result does not depend on O padding.
// The GN loop is gn.cuh gauss_newton, which K7 shares.
//
// Bound on the H100: arithmetic.  A GN iteration costs ~60 flops per
// observation (O = 3 on the seeding / follow path, O = V = 49 in
// expansion) and the per-point loop is sequential; reads are the point's
// own xy/mask (re-read each iteration from L1) and the tiny P table,
// which stays in L1/L2.

#include "gn.cuh"

namespace {

// Observation o of one point: [O] camera indices, [O, 2] points and an
// [O] mask, as K3's callers lay them out.
struct MaskedObs {
  const int* cam;
  const float* xy;
  const uint8_t* mask;
  __device__ __forceinline__ void operator()(int o, int* c, float* ox,
                                             float* oy, float* m) const {
    *c = cam[o];
    *ox = xy[2 * o];
    *oy = xy[2 * o + 1];
    *m = mask[o] ? 1.0f : 0.0f;
  }
};

__global__ void triangulate_gn_kernel(
    const float* __restrict__ P_mats, const int* __restrict__ cams,
    const float* __restrict__ xy, const uint8_t* __restrict__ mask, int N,
    int O, const float* __restrict__ X0, int max_iters, float epsilon,
    float accept_mse, float det_min, float* X_out, float* mse_out,
    uint8_t* valid_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int* cam = cams + n * O;
  const float* ob = xy + n * O * 2;
  const uint8_t* mk = mask + n * O;

  float mask_sum = 0.0f;
  for (int o = 0; o < O; ++o) mask_sum = mask_sum + (mk[o] ? 1.0f : 0.0f);

  float x, y, z;
  if (X0 != nullptr) {
    x = X0[3 * n];
    y = X0[3 * n + 1];
    z = X0[3 * n + 2];
  } else {
    float a00 = 0.f, a01 = 0.f, a02 = 0.f, a03 = 0.f, a11 = 0.f, a12 = 0.f,
          a13 = 0.f, a22 = 0.f, a23 = 0.f, a33 = 0.f;
    for (int o = 0; o < O; ++o) {
      const float* p = P_mats + (int64_t)cam[o] * 12;
      const float m = mk[o] ? 1.0f : 0.0f;
      for (int prow = 0; prow < 2; ++prow) {
        const float coord = ob[2 * o + prow];
        float r0 = coord * p[8] - p[4 * prow + 0];
        float r1 = coord * p[9] - p[4 * prow + 1];
        float r2 = coord * p[10] - p[4 * prow + 2];
        float r3 = coord * p[11] - p[4 * prow + 3];
        const float nrm = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + r3 * r3);
        const float scale = m / eg3d::nmax(nrm, 1e-12f);
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
    const float L11 = sqrtf(eg3d::nmax(a00, 1e-30f));
    const float L21 = a01 / L11;
    const float L31 = a02 / L11;
    const float L41 = a03 / L11;
    const float L22 = sqrtf(eg3d::nmax(a11 - L21 * L21, 1e-30f));
    const float L32 = (a12 - L31 * L21) / L22;
    const float L42 = (a13 - L41 * L21) / L22;
    const float L33 = sqrtf(eg3d::nmax(a22 - L31 * L31 - L32 * L32, 1e-30f));
    const float L43 = (a23 - L41 * L31 - L42 * L32) / L33;
    const float L44 =
        sqrtf(eg3d::nmax(a33 - L41 * L41 - L42 * L42 - L43 * L43, 1e-30f));
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
          eg3d::nmax(sqrtf(x1 * x1 + x2 * x2 + x3 * x3 + x4 * x4), 1e-30f);
      v0 = x1 / nn;
      v1 = x2 / nn;
      v2 = x3 / nn;
      v3 = x4 / nn;
    }
    const float w =
        (fabsf(v3) < 1e-12f) ? ((v3 < 0.0f) ? -1e-12f : 1e-12f) : v3;
    x = v0 / w;
    y = v1 / w;
    z = v2 / w;
  }

  const eg3d::GNResult r = eg3d::gauss_newton(
      P_mats, MaskedObs{cam, ob, mk}, O, mask_sum, x, y, z, max_iters,
      epsilon, accept_mse, det_min);
  X_out[3 * n] = r.x;
  X_out[3 * n + 1] = r.y;
  X_out[3 * n + 2] = r.z;
  mse_out[n] = r.mse;
  valid_out[n] = r.valid ? 1 : 0;
}

}  // namespace

extern "C" int eg3d_triangulate_gn(const float* P_mats, int V, const int* cams,
                                   const float* xy, const uint8_t* mask, int N,
                                   int O, const float* X0, int max_iters,
                                   float epsilon, float accept_mse,
                                   float det_min, float* X, float* mse,
                                   uint8_t* valid, void* stream) {
  (void)V;
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  triangulate_gn_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      P_mats, cams, xy, mask, N, O, X0, max_iters, epsilon, accept_mse,
      det_min, X, mse, valid);
  return (int)cudaGetLastError();
}
