// K2 epipolar_topm_query — epipolar-line correspondences from the grid.
//
// Replaces (JAX): edgegraph3d_tpu/matching/detection.py
//   detect_epipolar_correspondences (5x5 grid.gather_neighborhood +
//   segment x line intersection + _topm_distinct), vmapped over the
//   compacted starts x target views in refpoints._seed_from_starts and
//   over chain points in expansion._expand_candidates ("epipolar" mode).
//
// Per query: read the 5x5 cells around the observation, intersect every
// entry's segment with the query's normalized line, keep crossings
// within the query's radius (optionally dropping quasi-parallel
// segments), and keep the top-M distinct polylines.
//
// Design: shared neighbourhoods.  The 25 cells a query reads depend only
// on its view and the cell of its observation, and the seeding's queries
// share them heavily: every start of one refpoint carries the refpoint's
// observation on a view (at the full scene's seeding shape, 372 queries
// a distinct neighbourhood on average; PERF.md).  A warp takes 32
// consecutive queries of the visiting order and groups them by
// neighbourhood key (view, cell row, cell column).  For each group of at
// least `min_share` queries it stages the neighbourhood once in shared
// memory, its 32 lanes copying the 25 x Kc slots (float2 pieces, LOADS
// loads in flight a lane), then compacts them in place to the non-empty
// entries, keeping their gather index i in increasing order (a ballot
// and a prefix count a round).  Each query of the group then offers the
// staged entries in increasing i to its own TopM<M, T>: the sequential
// rule of grid_query.cuh epipolar_topm_one, whose `continue` skips the
// same empty slots, so every row is bit-equal to that body's by
// construction.  A query whose group is smaller than `min_share` runs
// epipolar_topm_one itself after the groups, beside the warp's other
// such queries (a warp of 32 distinct neighbourhoods then costs what the
// one-thread body costs, not 32 stagings).  Tasks of a block's 128
// queries, one staging for more queries behind block barriers, measured
// 4% slower on an H100 and were dropped.
//
// Visiting order.  The seeding's queries are N rows of every view (query
// q on view q % V); the wrapper says so (n_rows), and the kernel visits
// them by arithmetic in tiles of tile_rows rows, view-major within a
// tile: consecutive queries are consecutive rows on one view, so the
// starts of one refpoint form runs of one key, and a tile's output rows,
// V rows apart for one view, are all written while the tile runs, so
// their lines stay in L2 until whole.  Visited view-major over all rows,
// the outputs of one view are spread over the whole [Q, M] arrays and
// the kernel ran 2.2 times slower on an H100.  Other callers' queries are visited
// in a stable device sort by key (`order`).  Every query's result is
// written at its own index, so the layout never changes; each of its
// M-slot rows goes out as whole aligned vector stores (grid_query.cuh
// store_rows), not element by element.
//
// The C entry's `body` selects instead the one-thread-per-query body
// (grid_query.cuh epipolar_topm_one, which K7's "epipolar" mode runs per
// point); the wrapper never does, and the card tests and chip_smoke.py
// hold both bodies to identical results.
//
// Bound on the H100: bytes.  The queries (28 B each in f32), the [Q, M]
// outputs (25 M B) and each distinct cell read once (chip_smoke.py
// counts them); about 35 flops per non-empty entry tested.
//
// Types.  The lines, radii, thresholds and outputs are of the compute
// scalar T, the observation points of type Q (grid_query.cuh): f32/f32
// (the f32 bodies), f64 lines with f32 points (EdgeGraphConfig(dtype=
// "float64"): the stage-3 seeding's lines come from the f64 F table
// while its observations stay f32) and f64/f64.  The staged entries stay
// f32, as the grid is.

#include "grid_query.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps per block of the shared body
constexpr int LOADS = 8;  // float2 loads in flight a lane while staging

enum Body { SHARED = 0, ONE_THREAD = 1 };

template <class T, class Q>
struct K2Args {
  const float* grids;
  int GH, GW, Kc;
  const int* view;
  const Q* pts;
  const T* lines;
  const T* radius;
  const int* order;  // nullable: the visiting order
  int n_rows;        // without an order: > 0 visits N rows x V views
                     // view-major, in tiles of
  int tile_rows;     // rows (0: one tile)
  int Q_n;
  Q cell;
  int use_excl;
  T excl_cos;
  int min_share;
  eg3d::Out<T> out;
};

// The query visited at position j: order[j]; else, when the queries are
// n_rows rows of V views (query q on view q % V), view-major within tiles
// of tile_rows rows: the tile's rows on view 0, then on view 1, ...; else
// j.
template <class T, class Q>
__device__ __forceinline__ int64_t query_at(const K2Args<T, Q>& a,
                                            int64_t j) {
  if (a.order) return a.order[j];
  if (a.n_rows <= 0) return j;
  const int64_t V = a.Q_n / a.n_rows;
  const int64_t tr = a.tile_rows > 0 ? a.tile_rows : a.n_rows;
  const int64_t first = j / (tr * V) * tr;  // the tile's first row
  const int64_t rows = tr < a.n_rows - first ? tr : a.n_rows - first;
  const int64_t r = j - first * V;          // position in the tile
  return (first + r % rows) * V + r / rows;
}

template <int M, class T, class Q>
__global__ void epipolar_topm_kernel(K2Args<T, Q> a) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.Q_n) return;
  const int64_t q = query_at(a, j);
  const int64_t v = a.view[q];
  eg3d::TopM<M, T> top;
  eg3d::epipolar_topm_one<M>(a.grids, a.GH, a.GW, a.Kc, v, a.pts[2 * q],
                             a.pts[2 * q + 1], a.lines[3 * q],
                             a.lines[3 * q + 1], a.lines[3 * q + 2],
                             a.radius[q], a.cell, a.use_excl, a.excl_cos,
                             top);
  top.store(q, a.out.pl, a.out.seg, a.out.t, a.out.xy, a.out.dist,
            a.out.valid);
}

// Stages the non-empty entries of the 5x5 neighbourhood of cell (cx, cy)
// on view v into `st`, as one warp: the 25 x Kc slots (6 floats each, 3
// float2 pieces) copied in the reference's gather order (cell rows, cell
// columns, slots; cells clamped at the border as epipolar_topm_one clamps
// them), then compacted in place, each round of 32 slots moving its
// non-empty entries down to the next free positions in increasing gather
// index.  Returns the entries staged.
__device__ int stage_neighbourhood(const float* __restrict__ grids, int GH,
                                   int GW, int Kc, int v, int cy, int cx,
                                   float2* st) {
  const int lane = threadIdx.x & 31;
  const int U = 3 * Kc;  // float2 pieces a cell
  const int units = 25 * U;
  // piece u = c * U + off of cell c = (dy + 2) * 5 + (dx + 2), stepped
  // by 32 without a division per piece
  int c = lane / U, off = lane - (lane / U) * U;
  const int dc = 32 / U, doff = 32 - (32 / U) * U;
  for (int u0 = lane; u0 < units; u0 += LOADS * 32) {
    float2 buf[LOADS];
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      if (u0 + b * 32 < units) {
        const int row = c / 5;
        const int yy = eg3d::clampi(cy + row - 2, 0, GH - 1);
        const int xx = eg3d::clampi(cx + (c - 5 * row) - 2, 0, GW - 1);
        buf[b] = __ldg(reinterpret_cast<const float2*>(
                           eg3d::entry_ptr(grids, GH, GW, Kc, v, yy, xx, 0)) +
                       off);
      }
      off += doff;
      c += dc;
      if (off >= U) {
        off -= U;
        ++c;
      }
    }
#pragma unroll
    for (int b = 0; b < LOADS; ++b)
      if (u0 + b * 32 < units) st[u0 + b * 32] = buf[b];
  }
  __syncwarp();
  int n = 0;
  for (int i = lane; i - lane < 25 * Kc; i += 32) {
    float2 e0 = make_float2(-1.0f, 0.0f), e1 = e0, e2 = e0;
    bool ne = false;
    if (i < 25 * Kc) {
      e0 = st[3 * i];
      ne = (int)e0.x >= 0;  // load_entry's empty-slot test
      if (ne) {
        e1 = st[3 * i + 1];
        e2 = st[3 * i + 2];
      }
    }
    const unsigned b = __ballot_sync(FULL, ne);
    __syncwarp();  // every read of the round before any write
    if (ne) {      // p <= i: only slots already read are written
      const int p = n + __popc(b & ((1u << lane) - 1));
      st[3 * p] = e0;
      st[3 * p + 1] = e1;
      st[3 * p + 2] = e2;
    }
    n += __popc(b);
    __syncwarp();
  }
  return n;
}

// Entry e of a staged neighbourhood, as load_entry reads a slot.
__device__ __forceinline__ eg3d::Entry staged_entry(const float2* st,
                                                    int e) {
  const float2 a = st[3 * e], b = st[3 * e + 1], c = st[3 * e + 2];
  return eg3d::Entry{(int)a.x, (int)a.y, b.x, b.y, c.x, c.y};
}

// The shared-neighbourhood body: a warp takes 32 consecutive queries of
// the visiting order (see the top of the file).
template <int M, class T, class Q>
__global__ void __launch_bounds__(32 * WARPS)
    epipolar_topm_shared_kernel(K2Args<T, Q> a) {
  extern __shared__ float2 stage_mem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j0 = ((int64_t)blockIdx.x * WARPS + warp) * 32;
  if (j0 >= a.Q_n) return;  // the whole warp
  float2* st = stage_mem + (int64_t)warp * 25 * a.Kc * 3;
  const bool live = j0 + lane < a.Q_n;
  int64_t q = 0;
  int v = 0, cx = 0, cy = 0;
  Q ox = Q(0), oy = Q(0);
  T l0 = T(0), l1 = T(0), l2 = T(0), rad = T(0);
  if (live) {
    q = query_at(a, j0 + lane);
    v = a.view[q];
    ox = a.pts[2 * q];
    oy = a.pts[2 * q + 1];
    l0 = a.lines[3 * q];
    l1 = a.lines[3 * q + 1];
    l2 = a.lines[3 * q + 2];
    rad = a.radius[q];
    cx = eg3d::cell_of(ox, a.cell, a.GW);
    cy = eg3d::cell_of(oy, a.cell, a.GH);
  }
  eg3d::TopM<M, T> top;
  top.init();
  unsigned pend = __ballot_sync(FULL, live);  // the unserved lanes
  bool solo = false;
  while (pend) {
    // the first unserved query leads the group of the warp's queries
    // with its neighbourhood
    const int leader = __ffs(pend) - 1;
    const int lv = __shfl_sync(FULL, v, leader);
    const int lcy = __shfl_sync(FULL, cy, leader);
    const int lcx = __shfl_sync(FULL, cx, leader);
    const bool mine = live && v == lv && cy == lcy && cx == lcx;
    const unsigned g = __ballot_sync(FULL, mine);
    pend &= ~g;
    if (__popc(g) < a.min_share) {
      solo = solo || mine;
      continue;
    }
    const int n =
        stage_neighbourhood(a.grids, a.GH, a.GW, a.Kc, lv, lcy, lcx, st);
    if (mine) {
      for (int e = 0; e < n; ++e) {
        const eg3d::Entry en = staged_entry(st, e);
        T d, s, x, y;
        if (eg3d::epipolar_entry(en, ox, oy, l0, l1, l2, rad, a.use_excl,
                                 a.excl_cos, &d, &s, &x, &y))
          top.offer(d, en.pl, en.seg, s, x, y);
      }
    }
    __syncwarp();  // before the next group's staging overwrites st
  }
  if (solo)
    eg3d::epipolar_topm_one<M>(a.grids, a.GH, a.GW, a.Kc, v, ox, oy, l0, l1,
                               l2, rad, a.cell, a.use_excl, a.excl_cos, top);
  if (live) eg3d::store_rows(top, q, a.out);
}

template <int M, class T, class Q>
int launch_shared(const K2Args<T, Q>& a, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * 25 * a.Kc * 6 * sizeof(float);
  auto kern = epipolar_topm_shared_kernel<M, T, Q>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t warps = ((int64_t)a.Q_n + 31) / 32;
  kern<<<(int)((warps + WARPS - 1) / WARPS), 32 * WARPS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M, class T, class Q>
int launch(const K2Args<T, Q>& a, int body, cudaStream_t stream) {
  const int threads = 128;
  switch (body) {
    case SHARED: return launch_shared<M>(a, stream);
    case ONE_THREAD:
      epipolar_topm_kernel<M><<<(a.Q_n + threads - 1) / threads, threads, 0,
                                stream>>>(a);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class T, class Q>
int launch_m(const K2Args<T, Q>& a, int V, int M, int body, cudaStream_t s) {
  if (a.n_rows < 0 || (a.n_rows > 0 && (int64_t)a.n_rows * V != a.Q_n))
    return (int)cudaErrorInvalidValue;
  switch (M) {
    case 1: return launch<1>(a, body, s);
    case 2: return launch<2>(a, body, s);
    case 4: return launch<4>(a, body, s);
    case 8: return launch<8>(a, body, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// order: the visiting order (nullable); n_rows: without one, 0 (as
// given) or Q / V when query q is on view q % V (view-major in tiles of
// tile_rows rows, 0: one tile); body: 0 the shared-neighbourhood body
// (the wrapper's), 1 one thread a query; min_share: the smallest group of
// a warp whose neighbourhood the shared body stages.
extern "C" int eg3d_epipolar_topm(const float* grids, int V, int GH, int GW,
                                  int Kc, const int* view, const float* pts,
                                  const float* lines, const float* radius,
                                  const int* order, int n_rows,
                                  int tile_rows, int Q, float cell, int M,
                                  int body, int min_share,
                                  int use_excl, float excl_cos, int* pl,
                                  int* seg, float* t, float* xy, float* dist,
                                  uint8_t* valid, void* stream) {
  const K2Args<float, float> a{grids,    GH,       GW,       Kc,
                               view,     pts,      lines,    radius,
                               order,    n_rows,   tile_rows, Q,
                               cell,     use_excl, excl_cos, min_share,
                               {pl, seg, t, xy, dist, valid}};
  return launch_m(a, V, M, body, (cudaStream_t)stream);
}

// The f64 bodies: double lines, radii and outputs; the points double when
// pts_f64 != 0, else float (pts then points to floats).
extern "C" int eg3d_epipolar_topm_f64(
    const float* grids, int V, int GH, int GW, int Kc, const int* view,
    const void* pts, int pts_f64, const double* lines, const double* radius,
    const int* order, int n_rows, int tile_rows, int Q, double cell, int M,
    int body, int min_share, int use_excl, double excl_cos, int* pl, int* seg,
    double* t, double* xy, double* dist, uint8_t* valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const eg3d::Out<double> out{pl, seg, t, xy, dist, valid};
  if (pts_f64) {
    const K2Args<double, double> a{grids, GH, GW, Kc, view,
                                   (const double*)pts, lines, radius, order,
                                   n_rows, tile_rows, Q, cell, use_excl,
                                   excl_cos, min_share, out};
    return launch_m(a, V, M, body, s);
  }
  const K2Args<double, float> a{grids, GH, GW, Kc, view,
                                (const float*)pts, lines, radius, order,
                                n_rows, tile_rows, Q, (float)cell, use_excl,
                                excl_cos, min_share, out};
  return launch_m(a, V, M, body, s);
}
