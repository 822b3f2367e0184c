// K3 triangulate_gn — N-view DLT init + per-point Gauss-Newton.
//
// Replaces (JAX): edgegraph3d_tpu/ops/triangulation.py
//   triangulate_dlt_soa and gauss_newton_soa (and their tensor wrappers
//   triangulate_dlt / gauss_newton_batched), as called by
//   refpoints._seed_from_starts and polyline_stages._group_seed_sweep
//   (O = 3, cold) and outliers.gauss_newton_filter (warm, O = the most
//   observations of any point, prefix masks).  The follow path's GN runs
//   inside K4 and the expansion's inside K7, on the same device code.
//
// One thread per point.  Cameras come as an index [N, O] into P_mats
// [V, 3, 4].  DLT when X0 is null (gn.cuh dlt), then up to max_iters
// steps of gn.cuh gauss_newton; a point stops when it freezes or turns
// singular (exact: the JAX loop keeps iterating such points as no-ops).
// valid = !singular && last_mse < accept_mse && sum(mask) >= 2.
//
// Two bodies, picked by the O of the call:
//   * O = 3: the point's three cameras' P rows, points and weights are
//     loaded into registers once (gn.cuh LocalObs), so neither the DLT
//     nor the GN loop loads anything.  Masked observations keep the
//     padded form (weight 0).  No lane refill: the slowest row of a warp
//     sets its pace (29.9 GN iterations against a mean of 11.4 on
//     chip_smoke.py's rows), but a body that refilled after every
//     iteration ran 2.5x slower on an H100, since nearly every pass then
//     also runs some lane's loads and DLT (PERF.md).
//   * any other O: the block stages the P table in shared memory, and the
//     DLT and GN walk only the point's present observations, in
//     ascending o.  A masked observation adds exact zeros to the padded
//     sums while its intermediates are finite, so skipping it is
//     bit-equal.  Two guards keep the padded (JAX) result where that
//     fails: a point whose masked observations could overflow at any X
//     below 2^40 (a camera with an entry above 2^41, or a point beyond
//     2^60 or not finite) runs the padded loop; and the live GN carries
//     one extra weight-0 "probe" observation (camera row V of the staged
//     table) whose projection overflows once a coordinate of X reaches
//     2^40, so a trajectory that leaves the box where the masked terms
//     are provably finite ends in NaN, and the point is redone padded.
//     The table takes (V + 1) * 48 + V bytes.  The wrapper places it by
//     kernels.table_placement: in shared memory up to 48 KiB (V <= 1,002),
//     in opted-in shared memory up to the card's limit (V <= 4,742 on an
//     H100), else in device memory, where the same body reads P through
//     the read-only path with the probe row computed (ProbedTable), so
//     every camera count the JAX package runs is taken, bit-equal.
//
// Bound on the H100: arithmetic (~85 flops per observation and GN
// iteration), with a sequential per-point loop.

#include "gn.cuh"

namespace {

constexpr float TAME_P = 2199023255552.0f;          // 2^41
constexpr float TAME_XY = 1152921504606846976.0f;   // 2^60
constexpr float PROBE_SCALE = 309485009821345068724781056.0f;  // 2^88

// Observation o of one point, padded: [O] camera indices, [O, 2] points
// and an [O] mask, as K3's callers lay them out.
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

// The point's present observations in ascending o, then (when `probe` is
// set) the probe: camera `probe`, point (0, 0), weight 0.  Callers visit
// k = 0, 1, 2, ... in order, so the accessor keeps a cursor over the
// mask; any other order restarts the scan.
struct LiveObs {
  const int* cam;
  const float* xy;
  const uint8_t* mask;
  int n_live;
  int probe;  // camera index of the probe row, or -1
  mutable int k_at, o_at;
  __device__ __forceinline__ void operator()(int k, int* c, float* ox,
                                             float* oy, float* m) const {
    if (k >= n_live) {
      *c = probe;
      *ox = 0.0f;
      *oy = 0.0f;
      *m = 0.0f;
      return;
    }
    int o = (k == k_at + 1) ? o_at + 1 : 0;
    int skip = (k == k_at + 1) ? 0 : k;
    for (;; ++o) {
      if (mask[o]) {
        if (skip == 0) break;
        --skip;
      }
    }
    k_at = k;
    o_at = o;
    *c = cam[o];
    *ox = xy[2 * o];
    *oy = xy[2 * o + 1];
    *m = 1.0f;
  }
};

__device__ __forceinline__ void store(int64_t n, const eg3d::GNResult& r,
                                      float* X_out, float* mse_out,
                                      uint8_t* valid_out) {
  X_out[3 * n] = r.x;
  X_out[3 * n + 1] = r.y;
  X_out[3 * n + 2] = r.z;
  mse_out[n] = r.mse;
  valid_out[n] = r.valid ? 1 : 0;
}

__global__ void triangulate_gn3_kernel(
    const float* __restrict__ P_mats, const int* __restrict__ cams,
    const float* __restrict__ xy, const uint8_t* __restrict__ mask, int N,
    const float* __restrict__ X0, int max_iters, float epsilon,
    float accept_mse, float det_min, float* X_out, float* mse_out,
    uint8_t* valid_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  eg3d::LocalObs<3> ob;
  float mask_sum = 0.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float* p = P_mats + (int64_t)cams[3 * n + o] * 12;
#pragma unroll
    for (int k = 0; k < 12; ++k) ob.P[12 * o + k] = p[k];
    ob.x[o] = xy[6 * n + 2 * o];
    ob.y[o] = xy[6 * n + 2 * o + 1];
    ob.m[o] = mask[3 * n + o] ? 1.0f : 0.0f;
    mask_sum = mask_sum + ob.m[o];
  }
  float x, y, z;
  if (X0 != nullptr) {
    x = X0[3 * n];
    y = X0[3 * n + 1];
    z = X0[3 * n + 2];
  } else {
    eg3d::dlt(ob.P, ob, 3, &x, &y, &z);
  }
  store(n, eg3d::gauss_newton(ob.P, ob, 3, mask_sum, x, y, z, max_iters,
                              epsilon, accept_mse, det_min),
        X_out, mse_out, valid_out);
}

// Row k (0..11) of the probe camera [[s,0,0,0],[0,s,s,0],[0,0,0,1]].
__host__ __device__ constexpr float probe_entry(int k) {
  return (k == 0 || k == 5 || k == 6) ? PROBE_SCALE : (k == 11 ? 1.0f : 0.0f);
}

// The general body's camera table in device memory: P_mats [V, 12] read
// through the read-only path, and the probe as row V, computed rather
// than stored, so no scratch table is written.
struct ProbedTable {
  const float* p;
  int64_t n;    // 12 V
  int64_t off;
  __device__ __forceinline__ ProbedTable operator+(int64_t i) const {
    return ProbedTable{p, n, off + i};
  }
  __device__ __forceinline__ float operator[](int64_t k) const {
    const int64_t i = off + k;
    return i < n ? __ldg(p + i) : probe_entry((int)(i - n));
  }
};

// Whether camera c's P entries all lie within TAME_P, read from device
// memory (the global body's stand-in for the staged `tame` flags).
struct GlobalTame {
  const float* P;
  __device__ __forceinline__ bool operator[](int c) const {
    bool ok = true;
    for (int k = 0; k < 12; ++k)
      ok = ok && fabsf(__ldg(P + 12 * (int64_t)c + k)) <= TAME_P;
    return ok;
  }
};

// One row of the general body over the camera table `P` (V rows and the
// probe row V) and the cameras' `tame` flags.
template <class Tab, class Tame>
__device__ __forceinline__ void gn_row(
    const Tab P, const Tame tame, int V, int64_t n,
    const int* __restrict__ cams, const float* __restrict__ xy,
    const uint8_t* __restrict__ mask, int O, const float* __restrict__ X0,
    int max_iters, float epsilon, float accept_mse, float det_min,
    float* X_out, float* mse_out, uint8_t* valid_out) {
  const int* cam = cams + n * O;
  const float* ob = xy + n * O * 2;
  const uint8_t* mk = mask + n * O;

  // one pass over the row: the weight sum (in o order, as the padded
  // form sums it), the present count, and whether a masked observation
  // could leave the box where its padded terms are provably zero
  float mask_sum = 0.0f;
  int n_live = 0;
  bool padded = false;
  for (int o = 0; o < O; ++o) {
    if (mk[o]) {
      mask_sum = mask_sum + 1.0f;
      ++n_live;
    } else {
      const int c = cam[o];
      padded = padded || c < 0 || c >= V || !tame[c] ||
               !(fabsf(ob[2 * o]) <= TAME_XY) ||
               !(fabsf(ob[2 * o + 1]) <= TAME_XY);
    }
  }
  const MaskedObs all{cam, ob, mk};
  const LiveObs live{cam, ob, mk, n_live, V, -2, -1};
  float x, y, z;
  if (X0 != nullptr) {
    x = X0[3 * n];
    y = X0[3 * n + 1];
    z = X0[3 * n + 2];
  } else if (padded) {
    eg3d::dlt(P, all, O, &x, &y, &z);
  } else {
    eg3d::dlt(P, live, n_live, &x, &y, &z);
  }
  eg3d::GNResult r;
  if (!padded) {
    r = eg3d::gauss_newton(P, live, n_live + 1, mask_sum, x, y, z,
                           max_iters, epsilon, accept_mse, det_min);
    padded = r.mse != r.mse || r.x != r.x || r.y != r.y || r.z != r.z;
  }
  if (padded) {
    r = eg3d::gauss_newton(P, all, O, mask_sum, x, y, z, max_iters,
                           epsilon, accept_mse, det_min);
  }
  store(n, r, X_out, mse_out, valid_out);
}

// kGlobal = false: the block stages the table and the flags in shared
// memory (gn_smem_bytes); true: every read goes to device memory.
template <bool kGlobal>
__global__ void triangulate_gn_kernel(
    const float* __restrict__ P_mats, int V, const int* __restrict__ cams,
    const float* __restrict__ xy, const uint8_t* __restrict__ mask, int N,
    int O, const float* __restrict__ X0, int max_iters, float epsilon,
    float accept_mse, float det_min, float* X_out, float* mse_out,
    uint8_t* valid_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kGlobal) {
    if (n >= N) return;
    gn_row(ProbedTable{P_mats, 12 * (int64_t)V, 0}, GlobalTame{P_mats}, V,
           n, cams, xy, mask, O, X0, max_iters, epsilon, accept_mse, det_min,
           X_out, mse_out, valid_out);
  } else {
    extern __shared__ float P_sh[];                     // [V + 1, 3, 4]
    uint8_t* tame = (uint8_t*)(P_sh + (V + 1) * 12);    // [V]
    for (int i = threadIdx.x; i < V * 12; i += blockDim.x)
      P_sh[i] = P_mats[i];
    if (threadIdx.x < 12) P_sh[V * 12 + threadIdx.x] = probe_entry(threadIdx.x);
    __syncthreads();
    for (int c = threadIdx.x; c < V; c += blockDim.x) {
      bool ok = true;
      for (int k = 0; k < 12; ++k)
        ok = ok && fabsf(P_sh[12 * c + k]) <= TAME_P;
      tame[c] = ok ? 1 : 0;
    }
    __syncthreads();
    if (n >= N) return;
    gn_row((const float*)P_sh, (const uint8_t*)tame, V, n, cams, xy, mask,
           O, X0, max_iters, epsilon, accept_mse, det_min, X_out, mse_out,
           valid_out);
  }
}

int gn_smem_bytes(int V) {
  return (V + 1) * 12 * (int)sizeof(float) + V;
}

}  // namespace

// Dynamic shared memory of the general body's block (0 for O = 3).
extern "C" int eg3d_triangulate_gn_smem(int V, int O) {
  return O == 3 ? 0 : gn_smem_bytes(V);
}

// place (the general body): 0 the table in at most 48 KiB of shared
// memory, 1 in opted-in shared memory, 2 in device memory (kernels.py
// table_placement).
extern "C" int eg3d_triangulate_gn(const float* P_mats, int V, const int* cams,
                                   const float* xy, const uint8_t* mask, int N,
                                   int O, const float* X0, int max_iters,
                                   float epsilon, float accept_mse,
                                   float det_min, int place, float* X,
                                   float* mse, uint8_t* valid, void* stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (O == 3) {
    triangulate_gn3_kernel<<<blocks, threads, 0, s>>>(
        P_mats, cams, xy, mask, N, X0, max_iters, epsilon, accept_mse,
        det_min, X, mse, valid);
  } else if (place == 2) {
    triangulate_gn_kernel<true><<<blocks, threads, 0, s>>>(
        P_mats, V, cams, xy, mask, N, O, X0, max_iters, epsilon, accept_mse,
        det_min, X, mse, valid);
  } else {
    const int smem = gn_smem_bytes(V);
    if (place == 0 && smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (place == 1) {
      const cudaError_t e = cudaFuncSetAttribute(
          triangulate_gn_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    triangulate_gn_kernel<false><<<blocks, threads, smem, s>>>(
        P_mats, V, cams, xy, mask, N, O, X0, max_iters, epsilon, accept_mse,
        det_min, X, mse, valid);
  }
  return (int)cudaGetLastError();
}
