// K9 lmeds7_fit — OpenCV's FM_LMEDS (LMeDSPointSetRegistrator with
// FMEstimatorCallback) for every view pair of a scene in two launches:
// the 7-point models of every (pair, sample), then each valid model's
// upper median over its pair's points and each pair's least one.
//
// Replaces no TPU kernel: the JAX package fits its F table with its own
// LMedS-style estimator (ops/geometry.fundamental_lmeds).  It replaces
// the port's plain-torch FM_LMEDS (ops/geometry.fundamental_lmeds_opencv,
// its test twin and the path on the CPU), which on the card runs cuSOLVER's
// batched Jacobi SVD of 7x9 systems padded to 9x9, a [pairs, models,
// points] f64 error tensor and torch.kthvalue over it, a chunk of about 11
// pairs at a time with read-backs between chunks.
//
// Bound on the H100: float64 operations.  A DTU-sized scene scores 1.95 M
// models over up to 6,268 points each, 1.22e10 errors of 33 f64
// operations as err_bits forms them (12 fused multiply-adds of F x1h, r
// and the F^T x2h line, two squared norms, r * r, one division, one
// min; a fused multiply-add counts two): one pass over every error is
// ~11.8 ms at 34 TFLOP/s.  The selections below add passes.  The design
// follows:
//  * No error reaches device memory.  A block a pair stages its points in
//    shared memory (16 B each: x1, y1, x2, y2 as f32, widened to f64
//    exactly) and each warp scores one model at a time: every lane forms
//    the errors of every 32nd point in registers and compares them.
//  * Most models need no selection.  The pair's best key so far (score
//    bits << 32 | model index, the least wins) is a threshold t: one pass
//    counts the errors <= t and < t.  With at most n / 2 at or below t the
//    upper median exceeds t and the model cannot win; with at most n / 2
//    below t it equals t exactly.  Only a model whose median lies below t
//    is selected exactly, by four radix passes of 8 bits over the error
//    bits (non-negative floats order as their bits), each recomputing the
//    errors and counting digits in a warp-private histogram.  The winner
//    is the least key, whatever order the warps run in: deterministic.
//  * Pairs with more points than shared memory holds read them from
//    device memory through the read-only path instead (the template flag;
//    the wrapper decides from the largest pair, ops/lmeds7.launch_plan).
//
// The 7-point solve finds the null space of the 7x9 system by Gaussian
// elimination with complete pivoting and back substitution, then makes
// the two vectors orthonormal: another basis of the space the SVD spans,
// so the same models up to rounding, the roots in another order.  The
// cubic, the scaling of F[2,2] and the denormalisation are
// fundamental_7point's, in its operation order.  Everything is float64
// but the stored errors, which are rounded to float32 (NaN as +inf) as
// cv_epipolar_error stores them.

#undef NDEBUG
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int MODEL_THREADS = 128;  // threads a block of the model kernel
constexpr int WARPS = 8;            // warps a block of the scoring kernel
constexpr int THREADS = WARPS * 32;
constexpr int BINS = 256;           // radix digits a selection pass
constexpr unsigned FULL = 0xffffffffu;
constexpr double FLT_EPS = 1.1920928955078125e-07;  // np.finfo(f32).eps
constexpr double DBL_EPS = 2.220446049250313e-16;   // np.finfo(f64).eps
constexpr double TWO_PI_3 = 2.0943951023931953;     // 2 * np.pi / 3

// Shared bytes of a scoring block besides its points, at most: the
// warps' histograms, then 64 B for the pair's best key and the block
// sums' partials (ops/lmeds7.STATIC_SMEM_BYTES).
constexpr int STATIC_SMEM = WARPS * BINS * 4 + 64;

__device__ __forceinline__ double det3(const double* m) {
  return (m[0] * (m[4] * m[8] - m[5] * m[7]) -
          m[1] * (m[3] * m[8] - m[5] * m[6]) +
          m[2] * (m[3] * m[7] - m[4] * m[6]));
}

// sum(a * cofactors(m)): the cofactor rows are r1 x r2, r2 x r0, r0 x r1
__device__ __forceinline__ double dot_cof(const double* a, const double* m) {
  double c[9];
  for (int r = 0; r < 3; ++r) {
    const double* p = m + 3 * ((r + 1) % 3);
    const double* q = m + 3 * ((r + 2) % 3);
    c[3 * r] = p[1] * q[2] - p[2] * q[1];
    c[3 * r + 1] = p[2] * q[0] - p[0] * q[2];
    c[3 * r + 2] = p[0] * q[1] - p[1] * q[0];
  }
  double s = 0.0;
  for (int i = 0; i < 9; ++i) s += a[i] * c[i];
  return s;
}

// ops/geometry._solve_cubic for one equation: the real roots x[0..n-1].
__device__ int solve_cubic(double a0, double a1, double a2, double a3,
                           double* x) {
  x[0] = x[1] = x[2] = 0.0;
  if (a0 != 0.0) {
    const double inv = 1.0 / a0;
    const double b1 = a1 * inv, b2 = a2 * inv, b3 = a3 * inv;
    const double Q = (b1 * b1 - 3 * b2) * (1.0 / 9);
    const double R = (2 * b1 * b1 * b1 - 9 * b1 * b2 + 27 * b3) * (1.0 / 54);
    const double Qc = Q * Q * Q;
    const double d = Qc - R * R;
    const double t2 = b1 * (1.0 / 3);
    if (d > 0) {
      const double t0 = -2 * sqrt(Q);
      const double t1 = acos(fmin(fmax(R / sqrt(Qc), -1.0), 1.0)) * (1.0 / 3);
      x[0] = t0 * cos(t1 + 0.0) - t2;
      x[1] = t0 * cos(t1 + TWO_PI_3) - t2;
      x[2] = t0 * cos(t1 + -TWO_PI_3) - t2;
      return 3;
    }
    double e = pow(sqrt(-d) + fabs(R), 1.0 / 3);
    if (R > 0) e = -e;
    x[0] = e + Q / e - t2;
    return 1;
  }
  const double dq = a2 * a2 - 4 * a1 * a3;
  const double sq = sqrt(dq > 0 ? dq : 0.0);
  const double q1 = (-a2 + sq) * 0.5, q2 = (a2 + sq) * -0.5;
  const double q = fabs(q1) > fabs(q2) ? q1 : q2;
  if (a1 != 0) {
    x[0] = q / a1;
    x[1] = a3 / q;
    return (dq > 0) + (dq >= 0);
  }
  x[0] = -a3 / a2;
  return a2 != 0;
}

// One thread a (pair, sample): Hartley normalisation of the 7 sampled
// correspondences, the null space of the 7x9 system, the cubic's real
// roots and one model a root, scaled and denormalised as
// ops/geometry.fundamental_7point: models [P, 3T, 9] f64 (row-major F,
// model sample * 3 + root) and ok [P, 3T] (a root there, both sets
// spread, F finite).
__global__ void __launch_bounds__(MODEL_THREADS)
lmeds7_models_kernel(const float* __restrict__ x1,
                     const float* __restrict__ x2, int64_t N,
                     const int64_t* __restrict__ samples, int64_t P, int T,
                     double* __restrict__ models, uint8_t* __restrict__ ok) {
  const int64_t q = (int64_t)blockIdx.x * MODEL_THREADS + threadIdx.x;
  if (q >= P * T) return;
  const int64_t p = q / T;
  double a[7][2], b[7][2];
  for (int k = 0; k < 7; ++k) {
    const int64_t i = samples[q * 7 + k];
    assert(i >= 0 && i < N);
    const int64_t o = (p * N + i) * 2;
    a[k][0] = x1[o];
    a[k][1] = x1[o + 1];
    b[k][0] = x2[o];
    b[k][1] = x2[o + 1];
  }
  // centres, mean distances, scales (x.mean(-2), vector_norm(...).mean(-1))
  double c1x = 0, c1y = 0, c2x = 0, c2y = 0;
  for (int k = 0; k < 7; ++k) {
    c1x += a[k][0];
    c1y += a[k][1];
    c2x += b[k][0];
    c2y += b[k][1];
  }
  c1x /= 7;
  c1y /= 7;
  c2x /= 7;
  c2y /= 7;
  double d1 = 0, d2 = 0;
  for (int k = 0; k < 7; ++k) {
    const double ux = a[k][0] - c1x, uy = a[k][1] - c1y;
    const double vx = b[k][0] - c2x, vy = b[k][1] - c2y;
    d1 += sqrt(ux * ux + uy * uy);
    d2 += sqrt(vx * vx + vy * vy);
  }
  d1 /= 7;
  d2 /= 7;
  const bool spread = (d1 >= FLT_EPS) && (d2 >= FLT_EPS);
  const double s1 = 1.4142135623730951 / (spread ? d1 : 1.0);
  const double s2 = 1.4142135623730951 / (spread ? d2 : 1.0);
  double A[7][9];
  for (int k = 0; k < 7; ++k) {
    const double u0 = (a[k][0] - c1x) * s1, u1 = (a[k][1] - c1y) * s1;
    const double v0 = (b[k][0] - c2x) * s2, v1 = (b[k][1] - c2y) * s2;
    A[k][0] = v0 * u0;
    A[k][1] = v0 * u1;
    A[k][2] = v0;
    A[k][3] = v1 * u0;
    A[k][4] = v1 * u1;
    A[k][5] = v1;
    A[k][6] = u0;
    A[k][7] = u1;
    A[k][8] = 1.0;
  }
  // Gaussian elimination with complete pivoting: A P = L U, U 7x9 upper
  // trapezoidal; a step with no non-zero pivot left (rank < 7) takes the
  // constraint x_k = 0 instead, which keeps the basis inside the null space
  int perm[9];
  for (int j = 0; j < 9; ++j) perm[j] = j;
  for (int k = 0; k < 7; ++k) {
    int pi = k, pj = k;
    double top = 0.0;
    for (int i = k; i < 7; ++i)
      for (int j = k; j < 9; ++j)
        if (fabs(A[i][j]) > top) {
          top = fabs(A[i][j]);
          pi = i;
          pj = j;
        }
    for (int j = 0; j < 9; ++j) {
      const double t = A[k][j];
      A[k][j] = A[pi][j];
      A[pi][j] = t;
    }
    for (int i = 0; i < 7; ++i) {
      const double t = A[i][k];
      A[i][k] = A[i][pj];
      A[i][pj] = t;
    }
    const int t = perm[k];
    perm[k] = perm[pj];
    perm[pj] = t;
    if (!(top > 0.0)) {
      for (int j = 0; j < 9; ++j) A[k][j] = (j == k) ? 1.0 : 0.0;
      continue;
    }
    for (int i = k + 1; i < 7; ++i) {
      const double f = A[i][k] / A[k][k];
      A[i][k] = 0.0;
      for (int j = k + 1; j < 9; ++j) A[i][j] -= f * A[k][j];
    }
  }
  // back substitution for the free columns 7 and 8, then an orthonormal
  // pair: g0, g1 in the places of the SVD's last two right vectors
  double g[2][9];
  for (int f = 0; f < 2; ++f) {
    double x[9];
    x[7] = (f == 0) ? 1.0 : 0.0;
    x[8] = (f == 1) ? 1.0 : 0.0;
    for (int i = 6; i >= 0; --i) {
      double s = A[i][7] * x[7] + A[i][8] * x[8];
      for (int j = i + 1; j < 7; ++j) s += A[i][j] * x[j];
      x[i] = -s / A[i][i];
    }
    for (int j = 0; j < 9; ++j) g[f][perm[j]] = x[j];
  }
  double nn = 0.0;
  for (int j = 0; j < 9; ++j) nn += g[0][j] * g[0][j];
  nn = 1.0 / sqrt(nn);
  double dp = 0.0;
  for (int j = 0; j < 9; ++j) {
    g[0][j] *= nn;
    dp += g[1][j] * g[0][j];
  }
  nn = 0.0;
  for (int j = 0; j < 9; ++j) {
    g[1][j] -= dp * g[0][j];
    nn += g[1][j] * g[1][j];
  }
  nn = 1.0 / sqrt(nn);
  double f1[9], f2[9];  // F(lambda) = lambda f1 + f2
  for (int j = 0; j < 9; ++j) {
    f2[j] = g[1][j] * nn;
    f1[j] = g[0][j] - f2[j];
  }
  double x[3];
  const int n_roots = solve_cubic(det3(f1), dot_cof(f2, f1), dot_cof(f1, f2),
                                  det3(f2), x);
  for (int r = 0; r < 3; ++r) {
    const double s = f1[8] * x[r] + f2[8];
    const bool big = fabs(s) > DBL_EPS;
    const double mu = big ? 1.0 / s : 1.0;
    const double xm = x[r] * mu;
    double F[9];
    for (int j = 0; j < 8; ++j) F[j] = f1[j] * xm + f2[j] * mu;
    F[8] = big ? 1.0 : 0.0;
    // T2^T F T1, T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]]
    double G[9];
    for (int j = 0; j < 3; ++j) {
      G[j] = s2 * F[j];
      G[3 + j] = s2 * F[3 + j];
      G[6 + j] = -s2 * c2x * F[j] + -s2 * c2y * F[3 + j] + F[6 + j];
    }
    double H[9];
    for (int i = 0; i < 3; ++i) {
      H[3 * i] = G[3 * i] * s1;
      H[3 * i + 1] = G[3 * i + 1] * s1;
      H[3 * i + 2] = G[3 * i] * (-s1 * c1x) + G[3 * i + 1] * (-s1 * c1y) +
                     G[3 * i + 2];
    }
    const double f22 = H[8];
    bool finite = true;
    double* out = models + (q * 3 + r) * 9;
    for (int j = 0; j < 9; ++j) {
      const double v = fabs(f22) > FLT_EPS ? H[j] / f22 : H[j];
      finite = finite && isfinite(v);
      out[j] = v;
    }
    ok[q * 3 + r] = (r < n_roots) && spread && finite;
  }
}

// The pair's points, (x1, y1, x2, y2) a point: staged in shared memory,
// or read from device memory through the read-only path.
struct SharedPts {
  const float4* s;
  __device__ SharedPts(const float4* s_, const float2*, const float2*)
      : s(s_) {}
  __device__ __forceinline__ float4 operator[](int i) const { return s[i]; }
};
struct GlobalPts {
  const float2* a;
  const float2* b;
  __device__ GlobalPts(const float4*, const float2* a_, const float2* b_)
      : a(a_), b(b_) {}
  __device__ __forceinline__ float4 operator[](int i) const {
    const float2 u = __ldg(a + i), v = __ldg(b + i);
    return make_float4(u.x, u.y, v.x, v.y);
  }
};

// ops/geometry.cv_epipolar_error of one model F at one point, as the
// bits of its float32 value (NaN as +inf): the larger squared distance of
// x2 to F x1h and of x1 to F^T x2h, r^2 / min(|ab(F x1h)|^2,
// |ab(F^T x2h)|^2), in float64.  Errors are never negative, so their
// bits order as their values.
__device__ __forceinline__ uint32_t err_bits(const double* F, float4 pt) {
  const double x = pt.x, y = pt.y, u = pt.z, v = pt.w;
  const double l0 = fma(F[0], x, fma(F[1], y, F[2]));
  const double l1 = fma(F[3], x, fma(F[4], y, F[5]));
  const double l2 = fma(F[6], x, fma(F[7], y, F[8]));
  const double r = fma(u, l0, fma(v, l1, l2));
  const double a1 = fma(F[0], u, fma(F[3], v, F[6]));
  const double b1 = fma(F[1], u, fma(F[4], v, F[7]));
  const double d2 = fma(l0, l0, l1 * l1);
  const double d1 = fma(a1, a1, b1 * b1);
  const float e = (float)((r * r) / (d1 < d2 ? d1 : d2));
  return e != e ? 0x7f800000u : __float_as_uint(e);
}

// The element of rank k (0-based) of the first n errors of model F, by a
// warp: four radix passes of 8 bits, most significant first, each
// counting the digits of the errors that match the digits found so far
// in the warp's histogram `hist` (lanes with equal digits add once).
template <class Pts>
__device__ __forceinline__ uint32_t select_rank(const double* F,
                                                const Pts& pts, int n, int k,
                                                uint32_t* hist, int lane) {
  uint32_t prefix = 0, mask = 0;
  int rank = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < BINS; i += 32) hist[i] = 0;
    __syncwarp();
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      int digit = BINS;  // no digit: past n, or another prefix
      if (i < n) {
        const uint32_t e = err_bits(F, pts[i]);
        if ((e & mask) == prefix) digit = (e >> shift) & (BINS - 1);
      }
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit < BINS && lane == __ffs(peers) - 1)
        atomicAdd(hist + digit, (uint32_t)__popc(peers));
    }
    __syncwarp();
    // the digit whose bin holds rank `rank`: lane l sums bins 8l..8l+7
    uint32_t mine[BINS / 32];
    uint32_t sum = 0;
    for (int j = 0; j < BINS / 32; ++j) {
      mine[j] = hist[lane * (BINS / 32) + j];
      sum += mine[j];
    }
    uint32_t before = sum;  // inclusive scan over the lanes, then exclusive
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(FULL, before, d);
      if (lane >= d) before += o;
    }
    before -= sum;
    const bool here = (uint32_t)rank >= before && (uint32_t)rank < before + sum;
    int digit = 0, left = 0;
    if (here) {
      uint32_t c = before;
      for (int j = 0; j < BINS / 32; ++j) {
        if ((uint32_t)rank < c + mine[j]) {
          digit = lane * (BINS / 32) + j;
          left = rank - (int)c;
          break;
        }
        c += mine[j];
      }
    }
    const int src = __ffs(__ballot_sync(FULL, here)) - 1;
    digit = __shfl_sync(FULL, digit, src);
    rank = __shfl_sync(FULL, left, src);
    prefix |= (uint32_t)digit << shift;
    mask |= (uint32_t)(BINS - 1) << shift;
    __syncwarp();
  }
  return prefix;
}

// The per-pair outputs of the scoring kernel.
struct Fit {
  int64_t* counts;           // [P, 2] models, samples without one
  double* F;                 // [P, 9] the winner at unit Frobenius norm
  float* score;              // [P] its upper median, +inf without a model
  int64_t* best;             // [P] its index, sample * 3 + root (0 if none)
  uint8_t* valid;            // [P]
  uint8_t* inliers;          // [P, N]
};

// Sum of `v` over the block, in every thread.
__device__ __forceinline__ int block_sum(int v, int* part, int lane,
                                         int warp) {
  v = __reduce_add_sync(FULL, v);
  __syncthreads();
  if (lane == 0) part[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < WARPS; ++w) total += part[w];
  return total;
}

// One block a pair; warp w scores the pair's models w, w + WARPS, ...
// into the block's least key, then the block ends the fit as
// ops/geometry.lmeds_opencv_finish does: the winner's
// inliers (err <= sigma^2, sigma = max(2.5 * 1.4826 (1 + 5 / (n - 7))
// sqrt(score), 0.001), in that function's float32 and float64 steps),
// valid (n >= min_valid, a finite score, at least 7 inliers) and F at
// unit Frobenius norm, and counts the models and the samples without
// one.
template <bool kShared>
__global__ void __launch_bounds__(THREADS, 2)
lmeds7_score_kernel(const float* __restrict__ x1,
                    const float* __restrict__ x2, int64_t N,
                    const int64_t* __restrict__ n_common, int T,
                    int min_valid, const double* __restrict__ models,
                    const uint8_t* __restrict__ ok, Fit out) {
  extern __shared__ float4 s_pts[];
  __shared__ uint32_t s_hist[WARPS][BINS];
  __shared__ unsigned long long s_best;
  __shared__ int s_part[WARPS];
  const int64_t p = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = (int)n_common[p];
  const int M = 3 * T;
  const uint8_t* okp = ok + p * M;
  const float2* a = reinterpret_cast<const float2*>(x1) + p * N;
  const float2* b = reinterpret_cast<const float2*>(x2) + p * N;
  if (threadIdx.x == 0) s_best = ~0ull;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float2 u = __ldg(a + i), v = __ldg(b + i);
      s_pts[i] = make_float4(u.x, u.y, v.x, v.y);
    }
  }
  int n_models = 0, none = 0;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const int k0 = okp[3 * t], k1 = okp[3 * t + 1], k2 = okp[3 * t + 2];
    n_models += k0 + k1 + k2;
    none += !(k0 | k1 | k2);
  }
  n_models = block_sum(n_models, s_part, lane, warp);
  none = block_sum(none, s_part, lane, warp);
  if (threadIdx.x == 0) {
    out.counts[2 * p] = n_models;
    out.counts[2 * p + 1] = none;
  }
  __syncthreads();
  const typename std::conditional<kShared, SharedPts, GlobalPts>::type pts(
      s_pts, a, b);
  const int k = n / 2;  // the upper median's rank (nth_element at n / 2)
  volatile unsigned long long* best = &s_best;
  for (int m = warp; m < M; m += WARPS) {
    if (!okp[m] || n == 0) continue;
    double F[9];
    const double* src = models + (p * M + m) * 9;
    for (int j = 0; j < 9; ++j) F[j] = src[j];
    const uint32_t t = (uint32_t)(*best >> 32);
    int at_most = 0, below = 0;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const uint32_t e = err_bits(F, pts[i]);
      at_most += e <= t;
      below += e < t;
    }
    at_most = __reduce_add_sync(FULL, at_most);
    below = __reduce_add_sync(FULL, below);
    if (at_most <= k) continue;  // its median exceeds t: it cannot win
    const uint32_t med =
        below <= k ? t : select_rank(F, pts, n, k, s_hist[warp], lane);
    if (lane == 0)
      atomicMin(&s_best, ((unsigned long long)med << 32) | (unsigned)m);
    __syncwarp();
  }
  __syncthreads();
  const unsigned long long key = s_best;
  const bool has = key != ~0ull;
  const int64_t mb = has ? (int64_t)(key & 0xffffffffu) : 0;
  const float score = has ? __uint_as_float((uint32_t)(key >> 32)) : INFINITY;
  double F[9];
  for (int j = 0; j < 9; ++j) F[j] = models[(p * M + mb) * 9 + j];
  // sigma in the plain twin's types: 5.0 / (n - 7) is a float32
  // reciprocal times 5, the factor float32, sqrt(score) float64
  const float f = 1.0f + (1.0f / (float)(n - 7 > 1 ? n - 7 : 1)) * 5.0f;
  double sigma = (double)((float)(2.5 * 1.4826) * f) * sqrt((double)score);
  sigma = sigma < 0.001 ? 0.001 : sigma;
  const float thr = (float)(sigma * sigma);
  uint8_t* inl = out.inliers + p * N;
  int count = 0;
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool in = i < n && __uint_as_float(err_bits(F, pts[i])) <= thr;
    inl[i] = in;
    count += in;
  }
  count = block_sum(count, s_part, lane, warp);
  if (threadIdx.x == 0) {
    double sq = 0.0;
    for (int j = 0; j < 9; ++j) sq += F[j] * F[j];
    double norm = sqrt(sq);
    norm = norm < 1e-300 ? 1e-300 : norm;
    for (int j = 0; j < 9; ++j) out.F[p * 9 + j] = F[j] / norm;
    out.score[p] = score;
    out.best[p] = mb;
    out.valid[p] = n >= min_valid && isfinite(score) && count >= 7;
  }
}

}  // namespace

// Shared bytes of a scoring block that stages n_stage points: static and
// dynamic together (ops/lmeds7.smem_bytes).
extern "C" int eg3d_lmeds7_smem(int64_t n_stage) {
  return STATIC_SMEM + (int)(n_stage * (int64_t)sizeof(float4));
}

// x1, x2 [P, N, 2] f32 (each pair's points first), samples [P, T, 7]
// int64 positions below N, n_common [P] in [1, n_stage], n_stage <= N
// the most points a pair has, min_valid = max(min_points, 8).  Scratch:
// models [P, 3T, 9] f64, ok [P, 3T] u8.  Out: counts [P, 2] int64, F
// [P, 9] f64, score [P] f32, best [P] int64, valid [P] u8, inliers [P, N]
// u8.  place: 0 the points in at most 48 KiB of shared memory, 1 in
// opted-in shared memory, 2 in device memory (kernels.py
// table_placement).  Two launches on `stream`, one block a pair in the
// second.
extern "C" int eg3d_lmeds7_fit(const float* x1, const float* x2, int64_t N,
                               int64_t n_stage, const int64_t* samples,
                               const int64_t* n_common, int64_t P, int T,
                               int place, int min_valid, double* models,
                               uint8_t* ok, int64_t* counts, double* F,
                               float* score, int64_t* best, uint8_t* valid,
                               uint8_t* inliers, void* stream) {
  if (P <= 0 || T <= 0) return (int)cudaSuccess;
  if (n_stage < 1 || n_stage > N || place < 0 || place > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t threads = P * T;
  lmeds7_models_kernel<<<(unsigned)((threads + MODEL_THREADS - 1) /
                                    MODEL_THREADS),
                         MODEL_THREADS, 0, s>>>(x1, x2, N, samples, P, T,
                                                models, ok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Fit out{counts, F, score, best, valid, inliers};
  const unsigned blocks = (unsigned)P;
  if (place == 2) {
    lmeds7_score_kernel<false><<<blocks, THREADS, 0, s>>>(
        x1, x2, N, n_common, T, min_valid, models, ok, out);
    return (int)cudaGetLastError();
  }
  const int dyn = (int)(n_stage * (int64_t)sizeof(float4));
  if (place == 0 && dyn + STATIC_SMEM > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (place == 1) {
    e = cudaFuncSetAttribute(lmeds7_score_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  lmeds7_score_kernel<true><<<blocks, THREADS, dyn, s>>>(
      x1, x2, N, n_common, T, min_valid, models, ok, out);
  return (int)cudaGetLastError();
}
