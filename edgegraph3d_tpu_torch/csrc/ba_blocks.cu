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
// 1e-9.  Three kernels, launched in order by one entry:
//
//   ba_point_kernel, a warp per point (kPointWarps points a block), its
//   lanes over views.  The warp reads the point's O slots 32 at a time,
//   one a lane, and marks each present slot (max(cam, 0) its view) in a
//   shared-memory mask of the lane of that view; lane v then takes its
//   slots in slot order, so duplicate cameras add in slot order, and
//   the lanes take their k-th observations together.  Lane v writes its
//   row B[n, :, v, :] of the dense B [N, 3, V, 6] once, zeros included
//   (neighbouring lanes, neighbouring 24-byte pieces), and keeps its
//   share of Hxx and gx.  Those are summed over the lanes by a butterfly
//   (every lane ends with the same bits), each lane forms Hxx^-1 of
//   Hxx + damping diag(Hxx) + 1e-8 I (adjugate / det, det guarded at
//   1e-20 as linalg3.inv3) and its A[v, :, n, :] = B[n, :, v, :]^T
//   Hxx^-1 of the dense A [V, 6, N, 3] from its B rows, read back.  The
//   block stages two tables in shared memory: the cameras, one row a
//   camera entry, so that lanes over views read neighbouring words, and
//   the A rows of its points ([V * 6] rows of 3 * kPointWarps floats,
//   padded by one), written out row by row, since a lane's A rows lie
//   N * 3 floats apart.  Where they do not fit (kernels.table_placement)
//   the body reads the cameras from device memory and stores A straight
//   from the lanes.
//
//   ba_view_partial_kernel, a grid of (chunk, view) blocks over the
//   view-major observation index (ops/ba.py observation_index: the
//   present slots n * O + o sorted stably by camera, each view's in
//   (n, o) order, and a flag on the first slot of each (point, view)
//   pair).  Each block recomputes r and Jc for up to kViewObs of its
//   view's observations and sums Jc^T Jc (its upper triangle), Jc^T r,
//   r^T r and, at each pair's first slot, A[v, :, n, :] gx[n] (A already
//   sums a pair's duplicates); it writes one partial of those kSums sums.
//
//   ba_view_finish_kernel, one block, sums each view's partials in chunk
//   order into Hcc, gc and rhs = gc - sum A gx, and every partial's r^T r
//   into the residual sum; the observation count is the index's length.
//
// Every cross-thread sum is a shuffle tree, then warps in order, then
// chunks in order: no float atomics, so two runs give the same bits.
//
// Bound on the H100: bytes.  The dense A and B (2 x 72 V bytes a point)
// are what the function must write; the arithmetic is ~500 f32
// operations an observation.  The design writes each B row once with
// its neighbours, stages A so that it leaves in runs of 3 * kPointWarps
// floats, reads each point's slots 32 at a time, coalesced, and spreads
// the view sums over enough blocks to fill the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPointWarps = 8;                    // points a block
constexpr int kPointThreads = 32 * kPointWarps;
constexpr int kTileRow = 3 * kPointWarps + 1;     // a staged A row, padded
constexpr int kViewThreads = 256;
constexpr int kViewPerThread = 4;
constexpr int kViewObs = kViewThreads * kViewPerThread;
// Hcc's upper triangle 21, gc 6, sum A gx 6, r^T r 1
constexpr int kSums = 34;
constexpr int kFinishThreads = 1024;

struct Obs {
  float r[2];
  float jc[2][6];
  float jx[2][3];
};

// Camera v's K, R and t (row-major, 9 + 9 + 3 floats) in device memory,
// read through the read-only path.
struct CamGlobal {
  const float* __restrict__ K;
  const float* __restrict__ R;
  const float* __restrict__ t;
  __device__ float k(int i) const { return __ldg(K + i); }
  __device__ float r(int i) const { return __ldg(R + i); }
  __device__ float tr(int i) const { return __ldg(t + i); }
};

// Camera v of a table in shared memory whose row e holds entry e of
// every camera (K 0-8, R 9-17, t 18-20): a warp's lanes over views read
// neighbouring words.
struct CamShared {
  const float* row;  // the table + v
  int V;
  __device__ float k(int i) const { return row[i * V]; }
  __device__ float r(int i) const { return row[(9 + i) * V]; }
  __device__ float tr(int i) const { return row[(18 + i) * V]; }
};

// Residual and GN Jacobians of one observation (the same closed forms
// as ops/ba.py _residual_jacobians).
template <class Cam>
__device__ __forceinline__ void observe(const Cam& c, float X0, float X1,
                                        float X2, float ox, float oy,
                                        Obs& o) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = c.r(3 * i) * X0 + c.r(3 * i + 1) * X1 + c.r(3 * i + 2) * X2 +
           c.tr(i);
  const bool small = fabsf(p[2]) < 1e-9f;
  const float z = small ? 1e-9f : p[2];
  const float pz0 = p[0] / z, pz1 = p[1] / z, pz2 = p[2] / z;
  const float a = 1.0f / z;
  const float obs[2] = {ox, oy};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float k0 = c.k(3 * i), k1 = c.k(3 * i + 1), k2 = c.k(3 * i + 2);
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
      o.jx[i][j] = c.r(j) * d0 + c.r(3 + j) * d1 + c.r(6 + j) * d2;
  }
}

// Lane 0 ends with the warp's sum (a fixed tree).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(kFull, x, off);
  return x;
}

// Every lane ends with the warp's sum, the same bits in each: at every
// level lanes l and l ^ off add the same two values.
__device__ __forceinline__ float warp_sum_all(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Three blocks an SM (at most 85 registers a thread): on an H100 80GB
// HBM3 at 700 W, 0.2532-0.2546 ms against 0.3079-0.3151 ms at 90
// registers for `chip_smoke.py --time-k8`'s problem (61,008 points, 49
// views).
template <bool kShared>
__global__ void __launch_bounds__(kPointThreads, 3)
    ba_point_kernel(const float* __restrict__ K, const float* __restrict__ R,
                    const float* __restrict__ t, int V,
                    const float* __restrict__ X, const int* __restrict__ cam,
                    const float* __restrict__ xy,
                    const unsigned char* __restrict__ mask, int N, int O,
                    float damping, float* __restrict__ Hinv,
                    float* __restrict__ gx_out, float* __restrict__ B,
                    float* __restrict__ A) {
  // kShared: the camera table [21][V], then the A tile [V * 6][kTileRow]
  extern __shared__ float smem[];
  // a warp's 32 slots at a time: hit[w][l] = the slots lane l observes
  __shared__ unsigned hit[kPointWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kPointWarps;
  const int n = n0 + w;
  const int passes = (V + 31) >> 5;
  float* tile = smem + 21 * V;
  if (kShared) {
    for (int e = threadIdx.x; e < 21 * V; e += kPointThreads) {
      const int q = e / V, v = e - q * V;
      smem[e] = q < 9 ? K[9 * v + q] : q < 18 ? R[9 * v + q - 9]
                                              : t[3 * v + q - 18];
    }
    __syncthreads();
  }
  if (n < N) {  // uniform over the warp
    const float X0 = X[3 * (int64_t)n], X1 = X[3 * (int64_t)n + 1],
                X2 = X[3 * (int64_t)n + 2];
    const int* crow = cam + (int64_t)n * O;
    const unsigned char* mrow = mask + (int64_t)n * O;
    // Hxx's upper triangle (00 01 02 11 12 22) and gx, this lane's share
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float g[3] = {0.f, 0.f, 0.f};
    for (int p = 0; p < passes; ++p) {
      const int v = 32 * p + lane;
      float b[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) b[i][j] = 0.f;
      for (int base = 0; base < O; base += 32) {
        // each lane loads one slot and marks it at the lane of its view
        const int o = base + lane;
        const int c = o < O && __ldg(mrow + o) ? max(__ldg(crow + o), 0) : -1;
        hit[w][lane] = 0u;
        __syncwarp();
        if (c >= 32 * p && c < min(32 * p + 32, V))
          atomicOr(&hit[w][c - 32 * p], 1u << lane);
        __syncwarp();
        unsigned m = hit[w][lane];
        __syncwarp();
        // the lanes' k-th observations together, in slot order
        while (__any_sync(kFull, m != 0u)) {
          if (m != 0u) {
            const int64_t io = (int64_t)n * O + base + __ffs(m) - 1;
            m &= m - 1u;
            Obs ob;
            if constexpr (kShared)
              observe(CamShared{smem + v, V}, X0, X1, X2, xy[2 * io],
                      xy[2 * io + 1], ob);
            else
              observe(CamGlobal{K + 9 * v, R + 9 * v, t + 3 * v}, X0, X1,
                      X2, xy[2 * io], xy[2 * io + 1], ob);
            int q = 0;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
              for (int j = i; j < 3; ++j)
                h[q++] += ob.jx[0][i] * ob.jx[0][j] + ob.jx[1][i] * ob.jx[1][j];
              g[i] += ob.jx[0][i] * ob.r[0] + ob.jx[1][i] * ob.r[1];
#pragma unroll
              for (int j = 0; j < 6; ++j)
                b[i][j] +=
                    ob.jx[0][i] * ob.jc[0][j] + ob.jx[1][i] * ob.jc[1][j];
            }
          }
        }
      }
      if (v < V) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float2* row = reinterpret_cast<float2*>(
              B + (((int64_t)n * 3 + i) * V + v) * 6);
          row[0] = make_float2(b[i][0], b[i][1]);
          row[1] = make_float2(b[i][2], b[i][3]);
          row[2] = make_float2(b[i][4], b[i][5]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) h[q] = warp_sum_all(h[q]);
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = warp_sum_all(g[i]);
    // damped inverse: Hxx + damping diag(Hxx) + 1e-8 I, by adjugate / det
    const float a = (h[0] + damping * h[0]) + 1e-8f, bb = h[1], cc = h[2];
    const float d = h[1], e = (h[3] + damping * h[3]) + 1e-8f, f = h[4];
    const float gg = h[2], hh = h[4], ii = (h[5] + damping * h[5]) + 1e-8f;
    float det = a * (e * ii - f * hh) - bb * (d * ii - f * gg) +
                cc * (d * hh - e * gg);
    if (fabsf(det) < 1e-20f) det = det < 0.f ? -1e-20f : 1e-20f;
    const float inv[3][3] = {
        {(e * ii - f * hh) / det, (cc * hh - bb * ii) / det,
         (bb * f - cc * e) / det},
        {(f * gg - d * ii) / det, (a * ii - cc * gg) / det,
         (cc * d - a * f) / det},
        {(d * hh - e * gg) / det, (bb * gg - a * hh) / det,
         (a * e - bb * d) / det}};
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) Hinv[9 * (int64_t)n + 3 * i + j] = inv[i][j];
        gx_out[3 * (int64_t)n + i] = g[i];
      }
    }
    // A[v, i, n, k] = sum_j B[n, j, v, i] Hinv[j, k], from this lane's
    // own B rows, written above
    for (int p = 0; p < passes; ++p) {
      const int v = 32 * p + lane;
      if (v >= V) continue;
      float bv[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float2* row = reinterpret_cast<const float2*>(
            B + (((int64_t)n * 3 + i) * V + v) * 6);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float2 x = row[j];
          bv[i][2 * j] = x.x;
          bv[i][2 * j + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float x = bv[0][i] * inv[0][k] + bv[1][i] * inv[1][k] +
                          bv[2][i] * inv[2][k];
          if (kShared)
            tile[(v * 6 + i) * kTileRow + 3 * w + k] = x;
          else
            A[(((int64_t)v * 6 + i) * N + n) * 3 + k] = x;
        }
    }
  }
  if (kShared) {
    __syncthreads();
    // row (v, i) of the tile is A[v, i, n0 : n0 + kPointWarps, :]
    const int cols = 3 * min(kPointWarps, N - n0);
    for (int e = threadIdx.x; e < V * 6 * 3 * kPointWarps;
         e += kPointThreads) {
      const int row = e / (3 * kPointWarps), col = e - row * 3 * kPointWarps;
      if (col < cols)
        A[((int64_t)row * N + n0) * 3 + col] = tile[row * kTileRow + col];
    }
  }
}

__global__ void __launch_bounds__(kViewThreads)
    ba_view_partial_kernel(const float* __restrict__ K,
                           const float* __restrict__ R,
                           const float* __restrict__ t,
                           const float* __restrict__ X,
                           const float* __restrict__ xy, int O,
                           const int* __restrict__ slot,
                           const int* __restrict__ start,
                           const unsigned char* __restrict__ first,
                           const float* __restrict__ A,
                           const float* __restrict__ gx, int N, int chunks,
                           float* __restrict__ partial) {
  __shared__ float red[kViewThreads / 32][kSums];
  const int c = blockIdx.x, v = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = start[v] + c * kViewObs, end = start[v + 1];
  const CamGlobal cv{K + 9 * v, R + 9 * v, t + 3 * v};
  float acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
#pragma unroll
  for (int k = 0; k < kViewPerThread; ++k) {
    const int j = lo + k * kViewThreads + threadIdx.x;
    if (j >= end) break;
    const int s = slot[j];
    const int n = s / O;
    Obs ob;
    observe(cv, X[3 * (int64_t)n], X[3 * (int64_t)n + 1],
            X[3 * (int64_t)n + 2], xy[2 * (int64_t)s], xy[2 * (int64_t)s + 1],
            ob);
    int q = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int jj = i; jj < 6; ++jj)
        acc[q++] += ob.jc[0][i] * ob.jc[0][jj] + ob.jc[1][i] * ob.jc[1][jj];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[21 + i] += ob.jc[0][i] * ob.r[0] + ob.jc[1][i] * ob.r[1];
    acc[33] += ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1];
    if (first[j]) {
      const float g0 = gx[3 * (int64_t)n], g1 = gx[3 * (int64_t)n + 1],
                  g2 = gx[3 * (int64_t)n + 2];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float* a = A + (((int64_t)v * 6 + i) * N + n) * 3;
        acc[27 + i] += a[0] * g0 + a[1] * g1 + a[2] * g2;
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
    partial[((int64_t)v * chunks + c) * kSums + q] = s;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    ba_view_finish_kernel(const float* __restrict__ partial, int V,
                          int chunks, const int* __restrict__ start,
                          float* __restrict__ Hcc, float* __restrict__ gc,
                          float* __restrict__ rhs, float* __restrict__ rsum,
                          long long* __restrict__ nobs) {
  __shared__ float red[kFinishThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // per view: Hcc's 21 distinct entries, then the 6 (gc, rhs) pairs
  for (int e = threadIdx.x; e < V * 27; e += kFinishThreads) {
    const int v = e / 27, q = e - v * 27;
    const float* p = partial + (int64_t)v * chunks * kSums;
    if (q < 21) {
      float s = 0.f;
      for (int c = 0; c < chunks; ++c) s += p[c * kSums + q];
      int i = 0, r = q;
      while (r >= 6 - i) {
        r -= 6 - i;
        ++i;
      }
      const int j = i + r;
      Hcc[36 * v + 6 * i + j] = s;
      Hcc[36 * v + 6 * j + i] = s;
    } else {
      const int i = q - 21;
      float s = 0.f, ag = 0.f;
      for (int c = 0; c < chunks; ++c) {
        s += p[c * kSums + 21 + i];
        ag += p[c * kSums + 27 + i];
      }
      gc[6 * v + i] = s;
      rhs[6 * v + i] = s - ag;
    }
  }
  // the residual sum over every (view, chunk) partial
  float s = 0.f;
  for (int e = threadIdx.x; e < V * chunks; e += kFinishThreads)
    s += partial[(int64_t)e * kSums + 33];
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int k = 0; k < kFinishThreads / 32; ++k) total += red[k];
    *rsum = total;
    *nobs = start[V];
  }
}

// Dynamic shared memory of a point block with its tables in shared
// memory: the camera table and the A tile.
int dynamic_bytes(int V) {
  return (21 + 6 * kTileRow) * V * (int)sizeof(float);
}

// All the shared memory such a block takes (with the hit masks).
int shared_bytes(int V) {
  return dynamic_bytes(V) + kPointWarps * 32 * (int)sizeof(unsigned);
}

template <bool kShared>
cudaError_t launch_point(int smem, bool optin, cudaStream_t s,
                         const float* K, const float* R, const float* t,
                         int V, const float* X, const int* cam,
                         const float* xy, const unsigned char* mask, int N,
                         int O, float damping, float* Hinv, float* gx,
                         float* B, float* A) {
  if (optin) {
    const cudaError_t e = cudaFuncSetAttribute(
        ba_point_kernel<kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  ba_point_kernel<kShared>
      <<<(N + kPointWarps - 1) / kPointWarps, kPointThreads, smem, s>>>(
          K, R, t, V, X, cam, xy, mask, N, O, damping, Hinv, gx, B, A);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of a point block with its camera table and A tile
// (ops/ba.py ba_table_bytes).
extern "C" int eg3d_ba_blocks_smem(int V) { return shared_bytes(V); }

// slot [n_obs], start [V + 1], first [n_obs]: the view-major observation
// index (ops/ba.py observation_index), whose largest view holds
// max_count observations; partial [V, chunks, kSums] scratch, chunks *
// kViewObs >= max_count.  place: 0 the point blocks' camera table and A
// tile in at most 48 KiB of shared memory, 1 in opted-in shared memory,
// 2 neither (cameras read from device memory, A stored from the lanes;
// kernels.py table_placement).  Every output is written.
extern "C" int eg3d_ba_blocks(const float* K, const float* R, const float* t,
                              int V, const float* X, const int* cam,
                              const float* xy, const unsigned char* mask,
                              int N, int O, float damping, const int* slot,
                              const int* start, const unsigned char* first,
                              int max_count, int chunks, int place,
                              float* Hinv, float* gx, float* B, float* A,
                              float* partial, float* Hcc, float* gc,
                              float* rhs, float* rsum, long long* nobs,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks < 1 || (int64_t)chunks * kViewObs < max_count || V > 65535 ||
      place < 0 || place > 2)
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    if (place == 0 && shared_bytes(V) > 48 * 1024)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        place == 2
            ? launch_point<false>(0, false, s, K, R, t, V, X, cam, xy, mask,
                                  N, O, damping, Hinv, gx, B, A)
            : launch_point<true>(dynamic_bytes(V), place == 1, s, K, R, t, V,
                                 X, cam, xy, mask, N, O, damping, Hinv, gx,
                                 B, A);
    if (err != cudaSuccess) return (int)err;
  }
  if (V > 0) {
    ba_view_partial_kernel<<<dim3(chunks, V), kViewThreads, 0, s>>>(
        K, R, t, X, xy, O, slot, start, first, A, gx, N, chunks, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ba_view_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      partial, V, chunks, start, Hcc, gc, rhs, rsum, nobs);
  return (int)cudaGetLastError();
}
