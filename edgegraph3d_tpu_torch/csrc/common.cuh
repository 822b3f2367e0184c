// Shared device helpers of the edgegraph3d_tpu_torch kernels.
//
// Compiled with --fmad=false (see kernels.py): every expression below
// rounds after each multiply and add, exactly as the plain-torch twins
// do, so values that sit on a threshold decide the same way.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace eg3d {

constexpr float BIG = 1e30f;

// max/min that propagate NaN from the first operand, like jnp.maximum /
// torch.clamp (fmaxf/fminf would drop it).
static __device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
static __device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
static __device__ __forceinline__ float clip01(float t) {
  t = (t < 0.0f) ? 0.0f : t;
  return (t > 1.0f) ? 1.0f : t;
}
static __device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Grid cell of a coordinate: trunc toward zero, saturating, NaN -> 0
// (cvt.rzi.s32.f32 semantics; the plain twin clamps before converting).
static __device__ __forceinline__ int cell_of(float p, float cell, int n) {
  return clampi(__float2int_rz(p / cell), 0, n - 1);
}

// A read-only float table in device memory, read through the read-only
// (non-coherent) path: the stand-in for a table that a kernel otherwise
// stages in shared memory, indexed the same way (t + i, t[i]), so one
// body serves both placements with the same arithmetic.
struct Ldg {
  const float* p;
  __device__ __forceinline__ Ldg operator+(int64_t i) const {
    return Ldg{p + i};
  }
  __device__ __forceinline__ float operator[](int64_t i) const {
    return __ldg(p + i);
  }
};

// One polyline: `len` valid points of a row-major [L, 2] coordinate row
// (a pointer into shared or device memory, or an Ldg).
template <class Tab = const float*>
struct PolyT {
  Tab c;
  int len;
};
using Poly = PolyT<>;

// a * b + c with one rounding of the sum: the f64 product of two floats
// is exact, so only the f64 sum rounds before the cast (the form of
// ops.geometry._fma, bit for bit).
static __device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// polyline_ops.advance_by_distance_xy for one lane: the first segment in
// walk order (from `seg`) whose far end lies at least `radius` from
// (cx, cy), then the circle-segment root in the walk direction.  Returns
// found; writes the new position only when found.  The multiply-adds are
// the ones XLA's CPU code fuses in the JAX sampling scan and in the JAX
// follow's walk loop, each in one rounding (fma_f64): K6 samples and K4
// walks with it.
template <class Tab>
static __device__ __forceinline__ bool advance(const PolyT<Tab>& p, int seg,
                                               float cx, float cy, int dir,
                                               float radius, int* nseg,
                                               float* nt, float* nx,
                                               float* ny) {
  const float r2 = radius * radius;
  const bool fwd = dir > 0;
  int k = -1;
  if (fwd) {
    for (int j = seg < 0 ? 0 : seg; j < p.len - 1; ++j) {
      const float fx = p.c[2 * (j + 1)] - cx;
      const float fy = p.c[2 * (j + 1) + 1] - cy;
      if (fma_f64(fx, fx, fy * fy) >= r2) { k = j; break; }
    }
  } else {
    for (int j = (seg < p.len - 2 ? seg : p.len - 2); j >= 0; --j) {
      const float fx = p.c[2 * j] - cx;
      const float fy = p.c[2 * j + 1] - cy;
      if (fma_f64(fx, fx, fy * fy) >= r2) { k = j; break; }
    }
  }
  if (k < 0) return false;
  const float ax = p.c[2 * k], ay = p.c[2 * k + 1];
  const float ux = p.c[2 * (k + 1)] - ax;
  const float uy = p.c[2 * (k + 1) + 1] - ay;
  const float fx = ax - cx;
  const float fy = ay - cy;
  const float A = nmax(fma_f64(ux, ux, uy * uy), 1e-12f);
  const float B = 2.0f * fma_f64(ux, fx, uy * fy);
  const float C = fma_f64(fx, fx, fy * fy) - r2;
  const float disc = nmax(fma_f64(B, B, -((4.0f * A) * C)), 0.0f);
  const float sq = sqrtf(disc);
  float s = fwd ? (-B + sq) / (2.0f * A) : (-B - sq) / (2.0f * A);
  s = clip01(s);
  *nseg = k;
  *nt = s;
  *nx = fma_f64(s, ux, ax);
  *ny = fma_f64(s, uy, ay);
  return true;
}

// polyline_ops._segments_line_intersection_xy for one segment
// (ax, ay) -> (bx, by) and a normalized line (l0, l1, l2).
struct SegLine {
  float s;     // crossing parameter along the segment (0 if parallel)
  bool has;    // a crossing that is neither parallel nor quasi-parallel
  bool quasi;  // |cos| > qcos with an endpoint within qdist of the line
};

static __device__ __forceinline__ SegLine seg_line(float ax, float ay,
                                                   float bx, float by,
                                                   float l0, float l1,
                                                   float l2, float qcos,
                                                   float qdist) {
  const float sa = ax * l0 + ay * l1 + l2;
  const float sb = bx * l0 + by * l1 + l2;
  const float diff = sa - sb;
  const bool crosses = (sa * sb) <= 0.0f;
  const bool parallel = fabsf(diff) < 1e-9f;
  const float ux = bx - ax;
  const float uy = by - ay;
  const float ulen = nmax(sqrtf(ux * ux + uy * uy), 1e-12f);
  const float c = fabsf(-ux * l1 + uy * l0) / ulen;
  const bool near = nmin(fabsf(sa), fabsf(sb)) <= qdist;
  SegLine r;
  r.s = parallel ? 0.0f : sa / diff;
  r.quasi = (c > qcos) && near;
  r.has = crosses && !parallel && !r.quasi;
  return r;
}

// ops.geometry.epipolar_line: F (row-major 3x3) times [x, y, 1], scaled
// so l0^2 + l1^2 = 1.
template <class Tab>
static __device__ __forceinline__ void epipolar(const Tab F, float x,
                                                float y, float* l0,
                                                float* l1, float* l2) {
  const float a = F[0] * x + F[1] * y + F[2];
  const float b = F[3] * x + F[4] * y + F[5];
  const float c = F[6] * x + F[7] * y + F[8];
  const float ln = nmax(sqrtf(a * a + b * b), 1e-20f);
  *l0 = a / ln;
  *l1 = b / ln;
  *l2 = c / ln;
}

// ops.geometry.epipolar_line_fma: the line as XLA's CPU dot contracts
// it in the JAX stage-1/2 sweep, l_i = fma(F_i1, y, F_i0 x) + F_i2,
// normalized by sqrt(fma(a, a, b b)).
template <class Tab>
static __device__ __forceinline__ void epipolar_fma(const Tab F, float x,
                                                    float y, float* l0,
                                                    float* l1, float* l2) {
  const float a = fma_f64(F[1], y, F[0] * x) + F[2];
  const float b = fma_f64(F[4], y, F[3] * x) + F[5];
  const float c = fma_f64(F[7], y, F[6] * x) + F[8];
  const float ln = nmax(sqrtf(fma_f64(a, a, b * b)), 1e-20f);
  *l0 = a / ln;
  *l1 = b / ln;
  *l2 = c / ln;
}

// Top-M closest candidates with DISTINCT polyline ids, kept sorted by
// (distance, arrival order).  Candidates must be offered in the order
// the JAX reference gathers them (cell rows, cell columns, slots): a
// strict `<` everywhere makes the earliest of equal distances win, the
// first-index argmin of detection._topm_distinct.  Equivalent to its M
// rounds of "argmin, then suppress that polyline".  Everything is
// indexed with compile-time constants so it stays in registers.
template <int M>
struct TopM {
  float d[M];
  int pl[M];
  int seg[M];
  float t[M];
  float x[M];
  float y[M];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      d[i] = BIG;
      pl[i] = -1;
      seg[i] = 0;
      t[i] = 0.0f;
      x[i] = 0.0f;
      y[i] = 0.0f;
    }
  }

  __device__ __forceinline__ void set(int i, float dd, int p, int s, float tt,
                                      float xx, float yy) {
    d[i] = dd;
    pl[i] = p;
    seg[i] = s;
    t[i] = tt;
    x[i] = xx;
    y[i] = yy;
  }

  __device__ __forceinline__ void swap_down(int i) {  // swap i-1 <-> i
    float fd = d[i]; d[i] = d[i - 1]; d[i - 1] = fd;
    int ip = pl[i]; pl[i] = pl[i - 1]; pl[i - 1] = ip;
    int is = seg[i]; seg[i] = seg[i - 1]; seg[i - 1] = is;
    float ft = t[i]; t[i] = t[i - 1]; t[i - 1] = ft;
    float fx = x[i]; x[i] = x[i - 1]; x[i - 1] = fx;
    float fy = y[i]; y[i] = y[i - 1]; y[i - 1] = fy;
  }

  // dd must be a valid distance (< BIG / 2) and p >= 0.
  __device__ __forceinline__ void offer(float dd, int p, int s, float tt,
                                        float xx, float yy) {
    bool same = false;
    bool moved = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (pl[i] == p) {
        same = true;
        if (dd < d[i]) {
          set(i, dd, p, s, tt, xx, yy);
          moved = true;
        }
      }
    }
    if (same && !moved) return;
    if (!same) {
      if (!(dd < d[M - 1])) return;
      set(M - 1, dd, p, s, tt, xx, yy);
    }
    // one entry decreased: a single upward bubble pass restores order
#pragma unroll
    for (int i = M - 1; i > 0; --i) {
      if (d[i] < d[i - 1]) swap_down(i);
    }
  }

  // entry i holds a candidate (the `valid` the wrappers store)
  __device__ __forceinline__ bool ok(int i) const {
    return (d[i] < BIG * 0.5f) && (pl[i] >= 0);
  }

  __device__ __forceinline__ void store(int64_t q, int* pl_out, int* seg_out,
                                        float* t_out, float* xy_out,
                                        float* dist_out,
                                        uint8_t* valid_out) const {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const bool ok = this->ok(i);
      const int64_t o = q * M + i;
      pl_out[o] = ok ? pl[i] : -1;
      seg_out[o] = ok ? seg[i] : 0;
      t_out[o] = ok ? t[i] : 0.0f;
      xy_out[2 * o] = ok ? x[i] : 0.0f;
      xy_out[2 * o + 1] = ok ? y[i] : 0.0f;
      dist_out[o] = ok ? d[i] : BIG;
      valid_out[o] = ok ? 1 : 0;
    }
  }
};

}  // namespace eg3d
