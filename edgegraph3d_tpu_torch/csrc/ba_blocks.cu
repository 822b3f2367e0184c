// K8 ba_blocks — the per-point and per-view pieces of one joint-BA
// Levenberg-Marquardt step (Schur-complement reduction).
//
// Replaces (XLA program): edgegraph3d_tpu/ops/ba.py `ba_build_blocks`
//   (:82) and `ba_schur_local` (:125): per-observation residuals and
//   their Jacobians (jax.jacfwd through exp_so3), the per-point 3x3
//   blocks and their damped inverses, and the Schur pieces, scattered
//   per view with one-hot einsums ([N, O, V] one-hot, [N, O, 6, 6]
//   per-observation blocks).  The plain version is ops/ba.py
//   `_ba_blocks_plain`.
//
// Per observation, at dpose = 0 with p = R X + t, the Jacobians are
// written out: dp/dw = -[p]x, dp/du = I, dp/dX = R, and the GN Jacobian
// is J = d proj / d theta; where |p_z| < 1e-9 the depth is the constant
// 1e-9.  Two kernels, launched by one entry:
//
//   ba_point_kernel, one thread per point, loops over its O observations
//   and keeps Hxx, gx and the squared residual in registers; it adds
//   Hxc = Jx^T Jc of each observation into B[n, :, cam, :] (dense
//   [N, 3, V, 6], zero-filled by the wrapper; duplicate cameras add),
//   inverts Hxx + damping diag(Hxx) + 1e-8 I (adjugate / det, det
//   guarded at 1e-20 as linalg3.inv3), and writes A[v, :, n, :] =
//   B[n, :, v, :]^T Hxx^-1 for every view (dense [V, 6, N, 3]).  B and A
//   are the two operands of S = diag(Hcc) - A.view(6V, 3N) @
//   B.view(3N, 6V), which the wrapper's caller computes with one
//   torch.matmul; B also serves the back-substitution.
//
//   ba_view_kernel, one block per view (and one more block for the
//   residual sum), loops over all points: for each observation of the
//   view it recomputes r and Jc and adds Jc^T Jc and Jc^T r; for each
//   point seeing the view it adds A gx.  Each thread's 48 sums are
//   reduced by a shuffle tree in each warp, then warp by warp in order:
//   no float atomics, so two runs give the same bits.
//
// Bound on the H100: bytes.  The dense A and B (2 x 72 V bytes a point)
// dominate what the function must write; the arithmetic is ~500 f32
// operations an observation.  A simple first design: one thread per
// point (strided B writes) and V + 1 blocks for the view sums, which
// scan every point's O observations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Obs {
  float r[2];
  float jc[2][6];
  float jx[2][3];
};

// Residual and GN Jacobians of one observation (camera arrays row-major;
// the same closed forms as ops/ba.py _residual_jacobians).
__device__ __forceinline__ void observe(const float* __restrict__ K,
                                        const float* __restrict__ R,
                                        const float* __restrict__ t,
                                        float X0, float X1, float X2,
                                        float ox, float oy, Obs& o) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = __ldg(R + 3 * i) * X0 + __ldg(R + 3 * i + 1) * X1 +
           __ldg(R + 3 * i + 2) * X2 + __ldg(t + i);
  const bool small = fabsf(p[2]) < 1e-9f;
  const float z = small ? 1e-9f : p[2];
  const float pz0 = p[0] / z, pz1 = p[1] / z, pz2 = p[2] / z;
  const float a = 1.0f / z;
  const float obs[2] = {ox, oy};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float k0 = __ldg(K + 3 * i), k1 = __ldg(K + 3 * i + 1),
                k2 = __ldg(K + 3 * i + 2);
    const float proj = k0 * pz0 + k1 * pz1 + k2 * pz2;
    o.r[i] = obs[i] - proj;
    const float d0 = k0 * a, d1 = k1 * a, d2 = (small ? k2 : k2 - proj) * a;
    o.jc[i][0] = p[1] * d2 - p[2] * d1;
    o.jc[i][1] = p[2] * d0 - p[0] * d2;
    o.jc[i][2] = p[0] * d1 - p[1] * d0;
    o.jc[i][3] = d0;
    o.jc[i][4] = d1;
    o.jc[i][5] = d2;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.jx[i][j] = __ldg(R + j) * d0 + __ldg(R + 3 + j) * d1 +
                   __ldg(R + 6 + j) * d2;
  }
}

__global__ void ba_point_kernel(const float* __restrict__ K,
                                const float* __restrict__ R,
                                const float* __restrict__ t, int V,
                                const float* __restrict__ X,
                                const int* __restrict__ cam,
                                const float* __restrict__ xy,
                                const unsigned char* __restrict__ mask,
                                int N, int O, float damping,
                                float* __restrict__ Hinv,
                                float* __restrict__ gx_out,
                                float* __restrict__ B,
                                float* __restrict__ A,
                                float* __restrict__ rsq,
                                int* __restrict__ cnt) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float X0 = X[3 * n], X1 = X[3 * n + 1], X2 = X[3 * n + 2];
  float H[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float g[3] = {0.f, 0.f, 0.f};
  float rs = 0.f;
  int c = 0;
  const int64_t rowB = (int64_t)n * 3 * V;  // B[n, k, v, j]
  for (int o = 0; o < O; ++o) {
    const int64_t io = (int64_t)n * O + o;
    if (!mask[io]) continue;
    const int v = max(cam[io], 0);
    Obs ob;
    observe(K + 9 * v, R + 9 * v, t + 3 * v, X0, X1, X2, xy[2 * io],
            xy[2 * io + 1], ob);
    rs += ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1];
    ++c;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        H[i][j] += ob.jx[0][i] * ob.jx[0][j] + ob.jx[1][i] * ob.jx[1][j];
      g[i] += ob.jx[0][i] * ob.r[0] + ob.jx[1][i] * ob.r[1];
      float* b = B + ((rowB + (int64_t)i * V) + v) * 6;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        b[j] += ob.jx[0][i] * ob.jc[0][j] + ob.jx[1][i] * ob.jc[1][j];
    }
  }
  // damped inverse: Hxx + damping diag(Hxx) + 1e-8 I, by adjugate / det
  float m[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      m[i][j] = i == j ? (H[i][i] + damping * H[i][i]) + 1e-8f : H[i][j];
  const float a = m[0][0], b = m[0][1], cc = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float gg = m[2][0], h = m[2][1], ii = m[2][2];
  float det = a * (e * ii - f * h) - b * (d * ii - f * gg) +
              cc * (d * h - e * gg);
  if (fabsf(det) < 1e-20f) det = det < 0.f ? -1e-20f : 1e-20f;
  float inv[3][3] = {
      {(e * ii - f * h) / det, (cc * h - b * ii) / det,
       (b * f - cc * e) / det},
      {(f * gg - d * ii) / det, (a * ii - cc * gg) / det,
       (cc * d - a * f) / det},
      {(d * h - e * gg) / det, (b * gg - a * h) / det,
       (a * e - b * d) / det}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Hinv[9 * (int64_t)n + 3 * i + j] = inv[i][j];
    gx_out[3 * (int64_t)n + i] = g[i];
  }
  rsq[n] = rs;
  cnt[n] = c;
  // A[v, i, n, k] = sum_j B[n, j, v, i] Hinv[j, k]
  for (int v = 0; v < V; ++v) {
    float bv[3][6];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 6; ++i)
        bv[j][i] = B[((rowB + (int64_t)j * V) + v) * 6 + i];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        A[(((int64_t)v * 6 + i) * N + n) * 3 + k] =
            bv[0][i] * inv[0][k] + bv[1][i] * inv[1][k] +
            bv[2][i] * inv[2][k];
  }
}

constexpr int kViewThreads = 256;
constexpr int kSums = 48;  // Hcc 36, gc 6, sum_n A gx 6

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kViewThreads)
    ba_view_kernel(const float* __restrict__ K, const float* __restrict__ R,
                   const float* __restrict__ t, int V,
                   const float* __restrict__ X, const int* __restrict__ cam,
                   const float* __restrict__ xy,
                   const unsigned char* __restrict__ mask, int N, int O,
                   const float* __restrict__ A,
                   const float* __restrict__ gx,
                   const float* __restrict__ rsq,
                   const int* __restrict__ cnt, float* __restrict__ Hcc,
                   float* __restrict__ gc, float* __restrict__ rhs,
                   float* __restrict__ rsum,
                   long long* __restrict__ nobs) {
  __shared__ float red[kViewThreads / 32][kSums];
  __shared__ long long redc[kViewThreads / 32];
  const int v = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (v == V) {  // the residual sum and the observation count
    float s = 0.f;
    long long c = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      s += rsq[n];
      c += cnt[n];
    }
    s = warp_sum(s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) {
      red[warp][0] = s;
      redc[warp] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float ts = 0.f;
      long long tc = 0;
      for (int w = 0; w < kViewThreads / 32; ++w) {
        ts += red[w][0];
        tc += redc[w];
      }
      *rsum = ts;
      *nobs = tc;
    }
    return;
  }
  float acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
  const float* Kv = K + 9 * v;
  const float* Rv = R + 9 * v;
  const float* tv = t + 3 * v;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float X0 = X[3 * n], X1 = X[3 * n + 1], X2 = X[3 * n + 2];
    bool seen = false;
    for (int o = 0; o < O; ++o) {
      const int64_t io = (int64_t)n * O + o;
      if (!mask[io] || max(cam[io], 0) != v) continue;
      seen = true;
      Obs ob;
      observe(Kv, Rv, tv, X0, X1, X2, xy[2 * io], xy[2 * io + 1], ob);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          acc[6 * i + j] +=
              ob.jc[0][i] * ob.jc[0][j] + ob.jc[1][i] * ob.jc[1][j];
        acc[36 + i] += ob.jc[0][i] * ob.r[0] + ob.jc[1][i] * ob.r[1];
      }
    }
    if (seen) {
      const float g0 = gx[3 * (int64_t)n], g1 = gx[3 * (int64_t)n + 1],
                  g2 = gx[3 * (int64_t)n + 2];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float* a = A + (((int64_t)v * 6 + i) * N + n) * 3;
        acc[42 + i] += a[0] * g0 + a[1] * g1 + a[2] * g2;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
    const float s = warp_sum(acc[q]);
    if (lane == 0) red[warp][q] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    const int q = threadIdx.x;
    float s = 0.f;
    for (int w = 0; w < kViewThreads / 32; ++w) s += red[w][q];
    red[0][q] = s;  // each q is read and written by its own thread only
  }
  __syncthreads();
  if (threadIdx.x < 36) {
    Hcc[36 * v + threadIdx.x] = red[0][threadIdx.x];
  } else if (threadIdx.x < 42) {
    const int i = threadIdx.x - 36;
    gc[6 * v + i] = red[0][36 + i];
    rhs[6 * v + i] = red[0][36 + i] - red[0][42 + i];
  }
}

}  // namespace

// B must be zero-filled by the caller; every other output is written.
extern "C" int eg3d_ba_blocks(const float* K, const float* R, const float* t,
                              int V, const float* X, const int* cam,
                              const float* xy, const unsigned char* mask,
                              int N, int O, float damping, float* Hinv,
                              float* gx, float* B, float* A, float* rsq,
                              int* cnt, float* Hcc, float* gc, float* rhs,
                              float* rsum, long long* nobs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 0) {
    const int threads = 128;
    ba_point_kernel<<<(N + threads - 1) / threads, threads, 0, s>>>(
        K, R, t, V, X, cam, xy, mask, N, O, damping, Hinv, gx, B, A, rsq,
        cnt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ba_view_kernel<<<V + 1, kViewThreads, 0, s>>>(
      K, R, t, V, X, cam, xy, mask, N, O, A, gx, rsq, cnt, Hcc, gc, rhs,
      rsum, nobs);
  return (int)cudaGetLastError();
}
