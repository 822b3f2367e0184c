// K1 grid_topm_query — nearby-polyline candidates from the segment grid.
//
// Replaces (JAX): edgegraph3d_tpu/matching/detection.py
//   detect_starting_intersections (with grid.gather_neighborhood,
//   grid.point_segment_distance and _topm_distinct), vmapped over
//   queries inside refpoints._start_sweep, refpoints._locate_on_polylines
//   and polyline_stages._close_polylines.
//
// One thread per query: read the 3x3 cells around the point (clipped at
// the image border, so border cells repeat exactly as the reference's
// gather does), the cell's entries (pl, seg, ax, ay, bx, by), take the
// point-segment distance of each non-empty one, keep those within
// `radius`, and insert them into a register top-M of distinct polylines
// (common.cuh TopM).
//
// Two bodies, picked from the grid's shape before the launch:
//   * Kc = 8 (grid_cell_capacity's default): a cell is 8 x 24 = 192 B,
//     twelve 16-byte loads, all issued before any entry is tested, so the
//     cell's loads overlap instead of each waiting behind the previous
//     entry's branches.  The entries are then tested from registers in
//     index order with grid_query.cuh grid_entry, so the offers arrive in
//     the same order with the same arithmetic as in the generic body and
//     the plain version: bit-equal decisions.  The wrapper requires a
//     16-byte-aligned grid stack (the cell stride, 192 B, keeps it).
//   * any other Kc: grid_query.cuh grid_topm_one (the body K7 runs), an
//     8-byte (pl, seg) load per entry and the endpoints only for non-empty
//     slots.
// The outputs are written as whole rows: int4 / float4 (and uchar4 for
// `valid`) at M = 4 and 8, 8-byte stores at M = 2, scalars at M = 1 and
// 3.  The wrapper hands in views of three allocations, laid out so that
// every row is aligned (detection._empty_outputs).
//
// Visiting order.  The main path's callers lay the queries out as N rows
// of every view (query q on view q % V) and say so (n_rows = N); thread t
// then takes query (t % N) V + t / N, so a warp's lanes take neighbouring
// rows on one view, whose cells mostly coincide, and one cache line
// serves many lanes.  In the caller's order a warp's lanes read 32 views'
// cells and share nothing.  The order changes no result: each query reads
// view[q] and writes its own row.
//
// Bound on the H100: bytes.  The unique cells and the outputs (25 M + 12
// bytes a query) must move once; a query touches 9 x 192 B of cells, so
// without reuse between lanes the kernel streams ~1.7 KB a query from
// L2, and that traffic, not the ~21 flops per entry, set its time in the
// caller's order (PERF.md).

#include "grid_query.cuh"

namespace {

struct Out {
  int* pl;
  int* seg;
  float* t;
  float* xy;
  float* dist;
  uint8_t* valid;
};

// Component i of a register array of float4 (i a compile-time constant
// after unrolling, so this folds to one register).
template <int N>
__device__ __forceinline__ float comp(const float4 (&r)[N], int i) {
  const float4 q = r[i >> 2];
  switch (i & 3) {
    case 0: return q.x;
    case 1: return q.y;
    case 2: return q.z;
    default: return q.w;
  }
}

// K1's query over cells of KC entries, each cell loaded at once.
template <int M, int KC>
__device__ __forceinline__ void grid_topm_cells(const float* __restrict__ grids,
                                                int GH, int GW, int64_t v,
                                                float px, float py,
                                                float cell, float radius,
                                                eg3d::TopM<M>& top) {
  constexpr int N4 = KC * 6 / 4;
  const int cx = eg3d::cell_of(px, cell, GW);
  const int cy = eg3d::cell_of(py, cell, GH);
  top.init();
  for (int oy = -1; oy <= 1; ++oy) {
    const int yy = eg3d::clampi(cy + oy, 0, GH - 1);
    for (int ox = -1; ox <= 1; ++ox) {
      const int xx = eg3d::clampi(cx + ox, 0, GW - 1);
      const float4* c4 = reinterpret_cast<const float4*>(
          eg3d::entry_ptr(grids, GH, GW, KC, v, yy, xx, 0));
      float4 r[N4];
#pragma unroll
      for (int i = 0; i < N4; ++i) r[i] = __ldg(c4 + i);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        eg3d::Entry en;
        en.pl = (int)comp(r, 6 * k);
        if (en.pl < 0) continue;
        en.seg = (int)comp(r, 6 * k + 1);
        en.ax = comp(r, 6 * k + 2);
        en.ay = comp(r, 6 * k + 3);
        en.bx = comp(r, 6 * k + 4);
        en.by = comp(r, 6 * k + 5);
        eg3d::grid_entry(en, px, py, radius, top);
      }
    }
  }
}

// Store N values at dst (aligned to 4 N bytes for N % 4 == 0, 2 N for
// N == 2) in 16- or 8-byte pieces.
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_row(int* dst, const int (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<int4*>(dst)[i] =
          make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const uint8_t (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<uchar4*>(dst)[i] =
          make_uchar4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uchar2*>(dst) = make_uchar2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

// Query q's row of every output: the values TopM::store writes, row by
// row.
template <int M>
__device__ __forceinline__ void store(const eg3d::TopM<M>& top, int64_t q,
                                      const Out& o) {
  int pl[M], seg[M];
  float t[M], xy[2 * M], dist[M];
  uint8_t valid[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const bool ok = top.ok(i);
    pl[i] = ok ? top.pl[i] : -1;
    seg[i] = ok ? top.seg[i] : 0;
    t[i] = ok ? top.t[i] : 0.0f;
    xy[2 * i] = ok ? top.x[i] : 0.0f;
    xy[2 * i + 1] = ok ? top.y[i] : 0.0f;
    dist[i] = ok ? top.d[i] : eg3d::BIG;
    valid[i] = ok ? 1 : 0;
  }
  store_row(o.pl + q * M, pl);
  store_row(o.seg + q * M, seg);
  store_row(o.t + q * M, t);
  store_row(o.xy + q * 2 * M, xy);
  store_row(o.dist + q * M, dist);
  store_row(o.valid + q * M, valid);
}

// KC = 8: the cell-at-once body; KC = 0: the generic body (Kc at run
// time).
// n_rows > 0: the caller's queries are n_rows rows of V views (query q
// on view q % V), and thread t takes query (t % n_rows) V + t / n_rows,
// so a warp's lanes take neighbouring rows on one view.  Only the visiting
// order changes: each query still reads view[q] and writes its own row.
template <int M, int KC>
__global__ void grid_topm_kernel(const float* __restrict__ grids, int V,
                                 int GH, int GW, int Kc,
                                 const int* __restrict__ view,
                                 const float* __restrict__ pts, int Q,
                                 int n_rows, float cell, float radius,
                                 Out o) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Q) return;
  const int64_t q = n_rows > 0 ? (t % n_rows) * V + t / n_rows : t;
  const int64_t v = __ldg(view + q);
  const float2 p = __ldg(reinterpret_cast<const float2*>(pts) + q);
  eg3d::TopM<M> top;
  if constexpr (KC > 0) {
    grid_topm_cells<M, KC>(grids, GH, GW, v, p.x, p.y, cell, radius, top);
  } else {
    eg3d::grid_topm_one<M>(grids, GH, GW, Kc, v, p.x, p.y, cell, radius,
                           top);
  }
  store(top, q, o);
}

template <int M>
void launch(const float* grids, int V, int GH, int GW, int Kc,
            const int* view, const float* pts, int Q, int n_rows, float cell,
            float radius, const Out& o, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  if (Kc == 8) {
    grid_topm_kernel<M, 8><<<blocks, threads, 0, stream>>>(
        grids, V, GH, GW, Kc, view, pts, Q, n_rows, cell, radius, o);
  } else {
    grid_topm_kernel<M, 0><<<blocks, threads, 0, stream>>>(
        grids, V, GH, GW, Kc, view, pts, Q, n_rows, cell, radius, o);
  }
}

}  // namespace

// n_rows: 0, or Q / V when query q is on view q % V (see the kernel).
extern "C" int eg3d_grid_topm(const float* grids, int V, int GH, int GW,
                              int Kc, const int* view, const float* pts,
                              int Q, float cell, float radius, int M,
                              int n_rows, int* pl, int* seg, float* t,
                              float* xy, float* dist, uint8_t* valid,
                              void* stream) {
  if (n_rows < 0 || (n_rows > 0 && (int64_t)n_rows * V != Q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Out o{pl, seg, t, xy, dist, valid};
#define EG3D_LAUNCH(m) \
  launch<m>(grids, V, GH, GW, Kc, view, pts, Q, n_rows, cell, radius, o, s)
  switch (M) {
    case 1: EG3D_LAUNCH(1); break;
    case 2: EG3D_LAUNCH(2); break;
    case 3: EG3D_LAUNCH(3); break;
    case 4: EG3D_LAUNCH(4); break;
    case 8: EG3D_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EG3D_LAUNCH
  return (int)cudaGetLastError();
}
