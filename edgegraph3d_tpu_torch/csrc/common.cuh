// Shared device helpers of the edgegraph3d_tpu_torch kernels.
//
// Compiled with --fmad=false (see kernels.py): every expression below
// rounds after each multiply and add, exactly as the plain-torch twins
// do, so values that sit on a threshold decide the same way.
#pragma once

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

  __device__ __forceinline__ void store(int64_t q, int* pl_out, int* seg_out,
                                        float* t_out, float* xy_out,
                                        float* dist_out,
                                        uint8_t* valid_out) const {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const bool ok = (d[i] < BIG * 0.5f) && (pl[i] >= 0);
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
