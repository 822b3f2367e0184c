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
// The outputs are written as whole rows (grid_query.cuh store_rows):
// int4 / float4 (and uchar4 for `valid`) at M = 4 and 8, 8-byte stores
// at M = 2, scalars at M = 1 and 3.  The wrapper hands in views of three
// allocations, laid out so that every row is aligned
// (detection._empty_outputs).
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
//
// The query points' type Q is float or double (EdgeGraphConfig(dtype=
// "float64"): chain extension re-anchors f64 projections).  The grid stays
// f32; a query's distance, parameter and closest point are Q, as in the
// JAX package under x64 (grid_query.cuh grid_entry), and so are the
// outputs t, xy and dist.  The f64 body stores its rows as 16-byte
// double2 pieces where a row holds an even count, else as scalars.

#include "grid_query.cuh"

namespace {

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
template <int M, int KC, class Q>
__device__ __forceinline__ void grid_topm_cells(const float* __restrict__ grids,
                                                int GH, int GW, int64_t v,
                                                Q px, Q py, Q cell, Q radius,
                                                eg3d::TopM<M, Q>& top) {
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

// KC = 8: the cell-at-once body; KC = 0: the generic body (Kc at run
// time).
// n_rows > 0: the caller's queries are n_rows rows of V views (query q
// on view q % V), and thread t takes query (t % n_rows) V + t / n_rows,
// so a warp's lanes take neighbouring rows on one view.  Only the visiting
// order changes: each query still reads view[q] and writes its own row.
// A query point as one 8-byte (float2) or 16-byte (double2) load.
__device__ __forceinline__ float2 load_pt(const float* pts, int64_t q) {
  return __ldg(reinterpret_cast<const float2*>(pts) + q);
}
__device__ __forceinline__ double2 load_pt(const double* pts, int64_t q) {
  return __ldg(reinterpret_cast<const double2*>(pts) + q);
}

template <int M, int KC, class Q>
__global__ void grid_topm_kernel(const float* __restrict__ grids, int V,
                                 int GH, int GW, int Kc,
                                 const int* __restrict__ view,
                                 const Q* __restrict__ pts, int n_q,
                                 int n_rows, Q cell, Q radius,
                                 eg3d::Out<Q> o) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_q) return;
  const int64_t q = n_rows > 0 ? (t % n_rows) * V + t / n_rows : t;
  const int64_t v = __ldg(view + q);
  const auto p = load_pt(pts, q);
  eg3d::TopM<M, Q> top;
  if constexpr (KC > 0) {
    grid_topm_cells<M, KC>(grids, GH, GW, v, p.x, p.y, cell, radius, top);
  } else {
    eg3d::grid_topm_one<M>(grids, GH, GW, Kc, v, p.x, p.y, cell, radius,
                           top);
  }
  eg3d::store_rows(top, q, o);
}

template <int M, class Q>
void launch(const float* grids, int V, int GH, int GW, int Kc,
            const int* view, const Q* pts, int n_q, int n_rows, Q cell,
            Q radius, const eg3d::Out<Q>& o, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_q + threads - 1) / threads;
  if (Kc == 8) {
    grid_topm_kernel<M, 8, Q><<<blocks, threads, 0, stream>>>(
        grids, V, GH, GW, Kc, view, pts, n_q, n_rows, cell, radius, o);
  } else {
    grid_topm_kernel<M, 0, Q><<<blocks, threads, 0, stream>>>(
        grids, V, GH, GW, Kc, view, pts, n_q, n_rows, cell, radius, o);
  }
}

template <class Q>
int grid_topm(const float* grids, int V, int GH, int GW, int Kc,
              const int* view, const Q* pts, int n_q, Q cell, Q radius,
              int M, int n_rows, const eg3d::Out<Q>& o, cudaStream_t s) {
  if (n_rows < 0 || (n_rows > 0 && (int64_t)n_rows * V != n_q))
    return (int)cudaErrorInvalidValue;
#define EG3D_LAUNCH(m) \
  launch<m, Q>(grids, V, GH, GW, Kc, view, pts, n_q, n_rows, cell, radius, \
               o, s)
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

}  // namespace

// n_rows: 0, or Q / V when query q is on view q % V (see the kernel).
extern "C" int eg3d_grid_topm(const float* grids, int V, int GH, int GW,
                              int Kc, const int* view, const float* pts,
                              int Q, float cell, float radius, int M,
                              int n_rows, int* pl, int* seg, float* t,
                              float* xy, float* dist, uint8_t* valid,
                              void* stream) {
  return grid_topm<float>(grids, V, GH, GW, Kc, view, pts, Q, cell, radius,
                          M, n_rows,
                          eg3d::Out<float>{pl, seg, t, xy, dist, valid},
                          (cudaStream_t)stream);
}

// The f64 body: double query points (16-byte aligned), double outputs.
extern "C" int eg3d_grid_topm_f64(const float* grids, int V, int GH, int GW,
                                  int Kc, const int* view, const double* pts,
                                  int Q, double cell, double radius, int M,
                                  int n_rows, int* pl, int* seg, double* t,
                                  double* xy, double* dist, uint8_t* valid,
                                  void* stream) {
  return grid_topm<double>(grids, V, GH, GW, Kc, view, pts, Q, cell, radius,
                           M, n_rows,
                           eg3d::Out<double>{pl, seg, t, xy, dist, valid},
                           (cudaStream_t)stream);
}
