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

// The compute scalar T of a kernel body is float (the f32 bodies) or
// double (the f64 ones, EdgeGraphConfig(dtype="float64")).  Grid entries
// stay f32 in memory in both, and an expression mixes f32 and T exactly
// where the JAX package, under x64, mixes its f32 grids with its f64
// geometry: C++'s arithmetic conversions promote float to double at the
// same operations as jnp.result_type.  Literals are written T(v): JAX's
// Python floats are weakly typed and take the other operand's type
// (for f32, (float)v equals the float literal for every v used here).
template <class T>
__host__ __device__ __forceinline__ constexpr T big() {
  return T(1e30);
}

static __device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
static __device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
static __device__ __forceinline__ float vabs(float x) { return fabsf(x); }
static __device__ __forceinline__ double vabs(double x) { return fabs(x); }

// max/min that propagate NaN from the first operand, like jnp.maximum /
// torch.clamp (fmaxf/fminf would drop it).
static __device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
static __device__ __forceinline__ double nmax(double a, double b) {
  return (a != a || a > b) ? a : b;
}
static __device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
static __device__ __forceinline__ double nmin(double a, double b) {
  return (a != a || a < b) ? a : b;
}
template <class T>
static __device__ __forceinline__ T clip01(T t) {
  t = (t < T(0)) ? T(0) : t;
  return (t > T(1)) ? T(1) : t;
}
static __device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Grid cell of a coordinate: trunc toward zero, saturating, NaN -> 0
// (cvt.rzi.s32 semantics; the plain twin clamps before converting).  The
// division runs in the coordinate's own type, as the reference's
// `pt / cell` does.
static __device__ __forceinline__ int cell_of(float p, float cell, int n) {
  return clampi(__float2int_rz(p / cell), 0, n - 1);
}
static __device__ __forceinline__ int cell_of(double p, double cell, int n) {
  return clampi(__double2int_rz(p / cell), 0, n - 1);
}

// A read-only table (float or double) in device memory, read through
// the read-only (non-coherent) path: the stand-in for a table that a
// kernel otherwise stages in shared memory, indexed the same way (t + i,
// t[i]), so one body serves both placements with the same arithmetic.
template <class E>
struct LdgT {
  const E* p;
  __device__ __forceinline__ LdgT operator+(int64_t i) const {
    return LdgT{p + i};
  }
  __device__ __forceinline__ E operator[](int64_t i) const {
    return __ldg(p + i);
  }
};
using Ldg = LdgT<float>;

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
// The fused multiply-add of XLA's CPU code in the compute type: f32 as
// above, f64 the hardware's (fma.rn.f64; ops.geometry._fma emulates it
// exactly on the plain path).
static __device__ __forceinline__ float fmaT(float a, float b, float c) {
  return fma_f64(a, b, c);
}
static __device__ __forceinline__ double fmaT(double a, double b, double c) {
  return fma(a, b, c);
}

// polyline_ops.advance_by_distance_xy for one lane: the first segment in
// walk order (from `seg`) whose far end lies at least `radius` from
// (cx, cy), then the circle-segment root in the walk direction.  Returns
// found; writes the new position only when found.  The multiply-adds are
// the ones XLA's CPU code fuses in the JAX sampling scan and in the JAX
// follow's walk loop, each in one rounding (fma_f64): K6 samples and K4
// walks with it.
template <class T, class Tab>
static __device__ __forceinline__ bool advance(const PolyT<Tab>& p, int seg,
                                               T cx, T cy, int dir, T radius,
                                               int* nseg, T* nt, T* nx,
                                               T* ny) {
  const T r2 = radius * radius;
  const bool fwd = dir > 0;
  int k = -1;
  if (fwd) {
    for (int j = seg < 0 ? 0 : seg; j < p.len - 1; ++j) {
      const T fx = p.c[2 * (j + 1)] - cx;
      const T fy = p.c[2 * (j + 1) + 1] - cy;
      if (fmaT(fx, fx, fy * fy) >= r2) { k = j; break; }
    }
  } else {
    for (int j = (seg < p.len - 2 ? seg : p.len - 2); j >= 0; --j) {
      const T fx = p.c[2 * j] - cx;
      const T fy = p.c[2 * j + 1] - cy;
      if (fmaT(fx, fx, fy * fy) >= r2) { k = j; break; }
    }
  }
  if (k < 0) return false;
  const T ax = p.c[2 * k], ay = p.c[2 * k + 1];
  const T ux = p.c[2 * (k + 1)] - ax;
  const T uy = p.c[2 * (k + 1) + 1] - ay;
  const T fx = ax - cx;
  const T fy = ay - cy;
  const T A = nmax(fmaT(ux, ux, uy * uy), T(1e-12));
  const T B = T(2) * fmaT(ux, fx, uy * fy);
  const T C = fmaT(fx, fx, fy * fy) - r2;
  const T disc = nmax(fmaT(B, B, -((T(4) * A) * C)), T(0));
  const T sq = vsqrt(disc);
  T s = fwd ? (-B + sq) / (T(2) * A) : (-B - sq) / (T(2) * A);
  s = clip01(s);
  *nseg = k;
  *nt = s;
  *nx = fmaT(s, ux, ax);
  *ny = fmaT(s, uy, ay);
  return true;
}

// polyline_ops._segments_line_intersection_xy for one segment
// (ax, ay) -> (bx, by) and a normalized line (l0, l1, l2).
template <class T>
struct SegLine {
  T s;         // crossing parameter along the segment (0 if parallel)
  bool has;    // a crossing that is neither parallel nor quasi-parallel
  bool quasi;  // |cos| > qcos with an endpoint within qdist of the line
};

template <class T>
static __device__ __forceinline__ SegLine<T> seg_line(T ax, T ay, T bx, T by,
                                                      T l0, T l1, T l2,
                                                      T qcos, T qdist) {
  const T sa = ax * l0 + ay * l1 + l2;
  const T sb = bx * l0 + by * l1 + l2;
  const T diff = sa - sb;
  const bool crosses = (sa * sb) <= T(0);
  const bool parallel = vabs(diff) < T(1e-9);
  const T ux = bx - ax;
  const T uy = by - ay;
  const T ulen = nmax(vsqrt(ux * ux + uy * uy), T(1e-12));
  const T c = vabs(-ux * l1 + uy * l0) / ulen;
  const bool near = nmin(vabs(sa), vabs(sb)) <= qdist;
  SegLine<T> r;
  r.s = parallel ? T(0) : sa / diff;
  r.quasi = (c > qcos) && near;
  r.has = crosses && !parallel && !r.quasi;
  return r;
}

// ops.geometry.epipolar_line: F (row-major 3x3) times [x, y, 1], scaled
// so l0^2 + l1^2 = 1.
template <class T, class Tab>
static __device__ __forceinline__ void epipolar(const Tab F, T x, T y, T* l0,
                                                T* l1, T* l2) {
  const T a = F[0] * x + F[1] * y + F[2];
  const T b = F[3] * x + F[4] * y + F[5];
  const T c = F[6] * x + F[7] * y + F[8];
  const T ln = nmax(vsqrt(a * a + b * b), T(1e-20));
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
template <int M, class T = float>
struct TopM {
  T d[M];
  int pl[M];
  int seg[M];
  T t[M];
  T x[M];
  T y[M];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      d[i] = big<T>();
      pl[i] = -1;
      seg[i] = 0;
      t[i] = T(0);
      x[i] = T(0);
      y[i] = T(0);
    }
  }

  __device__ __forceinline__ void set(int i, T dd, int p, int s, T tt, T xx,
                                      T yy) {
    d[i] = dd;
    pl[i] = p;
    seg[i] = s;
    t[i] = tt;
    x[i] = xx;
    y[i] = yy;
  }

  __device__ __forceinline__ void swap_down(int i) {  // swap i-1 <-> i
    T fd = d[i]; d[i] = d[i - 1]; d[i - 1] = fd;
    int ip = pl[i]; pl[i] = pl[i - 1]; pl[i - 1] = ip;
    int is = seg[i]; seg[i] = seg[i - 1]; seg[i - 1] = is;
    T ft = t[i]; t[i] = t[i - 1]; t[i - 1] = ft;
    T fx = x[i]; x[i] = x[i - 1]; x[i - 1] = fx;
    T fy = y[i]; y[i] = y[i - 1]; y[i - 1] = fy;
  }

  // dd must be a valid distance (< BIG / 2) and p >= 0.
  __device__ __forceinline__ void offer(T dd, int p, int s, T tt, T xx,
                                        T yy) {
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
    return (d[i] < big<T>() * T(0.5)) && (pl[i] >= 0);
  }

  __device__ __forceinline__ void store(int64_t q, int* pl_out, int* seg_out,
                                        T* t_out, T* xy_out, T* dist_out,
                                        uint8_t* valid_out) const {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const bool ok = this->ok(i);
      const int64_t o = q * M + i;
      pl_out[o] = ok ? pl[i] : -1;
      seg_out[o] = ok ? seg[i] : 0;
      t_out[o] = ok ? t[i] : T(0);
      xy_out[2 * o] = ok ? x[i] : T(0);
      xy_out[2 * o + 1] = ok ? y[i] : T(0);
      dist_out[o] = ok ? d[i] : big<T>();
      valid_out[o] = ok ? 1 : 0;
    }
  }
};

}  // namespace eg3d
