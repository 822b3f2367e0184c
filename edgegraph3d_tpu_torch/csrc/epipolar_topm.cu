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
// Design.  A group of LANES = 8 lanes serves one query (a group of 32
// measured slower at every query order: five merge rounds instead of
// three, over six or seven entries a lane).  The neighbourhood is
// 25 * Kc entries in the reference's gather order (cell rows, cell
// columns, slots); entry i = ((dy + 2) * 5 + (dx + 2)) * Kc + k goes to
// lane i % LANES, so the group reads each row of 5 cells (5 * Kc
// entries of 24 B, one contiguous run unless the image border clamps a
// cell) coalesced, (pl, seg) as one float2 and the endpoints of
// non-empty slots as two more.  Each lane keeps a partial top-M of keys
// (distance, i, polyline) (grid_query.cuh TopKey), and the group merges
// the partials by xor shuffles in log2(LANES) rounds.  Lane m < M then
// recomputes the m-th winner's crossing from its entry (the arithmetic
// that ranked it) and stores it, so the merge moves three words per
// candidate and the stores of one query spread over M lanes.
//
// Why the merge equals the sequential rule (TopM<M>::offer over all 25 *
// Kc entries in order, the first-index argmin rounds of
// detection._topm_distinct).  That rule keeps the M polylines of smallest
// key, a polyline's key being its smallest (distance, i) entry.  Take a
// polyline p of the global top-M and the lane that holds its smallest
// entry.  If p were missing from that lane's partial, the lane would hold
// M other distinct polylines with keys below p's, all of them keys of the
// whole neighbourhood too, so p could not be in the global top-M: a
// contradiction.  So every polyline of the global top-M reaches the
// merge at its own key, and any other polyline reaches it at a key no
// smaller than its true one, which already ranks below those M.  Merging
// two partials is the same keep-the-M-smallest rule over the union of
// their candidates, so it is associative and the order of the rounds
// does not matter.  Keys are distinct (i names one entry; a cell that the
// border repeats has other i), so ties between equal distances fall to
// the earliest entry, as in the sequential rule.
//
// Query order.  The wrapper hands the queries in a stable view-major
// order (a device sort); the kernel reads query order[j] and writes its
// result at that query's own index, so the output layout does not
// change.  Callers issue queries start-major (every target view of one
// start side by side); view-major, consecutive groups read the same
// view's grid (about 3.7 MB at 1600x1200), so only one or two views'
// grids are live in L2 at a time instead of up to 32 per warp.  Sorting
// by grid cell within a view as well measured no faster.
//
// The C entry's `one_thread` flag launches instead the one-thread-per-query
// body (grid_query.cuh epipolar_topm_one, which K7's "epipolar" mode runs
// per point); the wrapper never sets it, and the card tests and
// chip_smoke.py hold the two bodies to identical results.
//
// Bound on the H100: bytes.  25 cells x 8 entries x 24 B = 4.8 KB of
// gathered grid per query against ~35 flops per entry; the bytes that
// must move are the queries, the [Q, M] outputs and each distinct cell
// read once (chip_smoke.py counts them).

#include "grid_query.cuh"

namespace {

constexpr int LANES = 8;  // lanes per query in the group body

struct K2Args {
  const float* grids;
  int GH, GW, Kc;
  const int* view;
  const float* pts;
  const float* lines;
  const float* radius;
  const int* order;  // nullable: identity
  int Q;
  float cell;
  int use_excl;
  float excl_cos;
  int* pl;
  int* seg;
  float* t;
  float* xy;
  float* dist;
  uint8_t* valid;
};

template <int M>
__global__ void epipolar_topm_kernel(K2Args a) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.Q) return;
  const int64_t q = a.order ? a.order[j] : j;
  const int64_t v = a.view[q];
  eg3d::TopM<M> top;
  eg3d::epipolar_topm_one<M>(a.grids, a.GH, a.GW, a.Kc, v, a.pts[2 * q],
                             a.pts[2 * q + 1], a.lines[3 * q],
                             a.lines[3 * q + 1], a.lines[3 * q + 2],
                             a.radius[q], a.cell, a.use_excl, a.excl_cos,
                             top);
  top.store(q, a.pl, a.seg, a.t, a.xy, a.dist, a.valid);
}

template <int M>
__global__ void epipolar_topm_group_kernel(K2Args a) {
  constexpr int G = LANES;
  const int64_t j = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int gl = threadIdx.x & (G - 1);
  const bool live = j < a.Q;
  const int Kc = a.Kc;
  eg3d::TopKey<M> top;
  top.init();
  int64_t q = 0;
  const float* vg = a.grids;  // this query's view of the grid stack
  float ox = 0.f, oy = 0.f, l0 = 0.f, l1 = 0.f, l2 = 0.f, rad = 0.f;
  int cx = 0, cy = 0;
  if (live) {
    q = a.order ? a.order[j] : j;
    vg += (int64_t)a.view[q] * a.GH * a.GW * Kc * 6;
    ox = a.pts[2 * q];
    oy = a.pts[2 * q + 1];
    l0 = a.lines[3 * q];
    l1 = a.lines[3 * q + 1];
    l2 = a.lines[3 * q + 2];
    rad = a.radius[q];
    cx = eg3d::cell_of(ox, a.cell, a.GW);
    cy = eg3d::cell_of(oy, a.cell, a.GH);
    // entry i = c * Kc + k of cell c = (dy + 2) * 5 + (dx + 2), stepped
    // by G without a division per entry
    int c = gl / Kc, k = gl - (gl / Kc) * Kc;
    const int dc = G / Kc, dk = G - (G / Kc) * Kc;
    for (int i = gl; i < 25 * Kc; i += G) {
      const int r = c / 5;
      const int yy = eg3d::clampi(cy + r - 2, 0, a.GH - 1);
      const int xx = eg3d::clampi(cx + (c - 5 * r) - 2, 0, a.GW - 1);
      eg3d::Entry en;
      float d, s, x, y;
      if (eg3d::load_entry(vg + ((yy * a.GW + xx) * Kc + k) * 6, &en) &&
          eg3d::epipolar_entry(en, ox, oy, l0, l1, l2, rad, a.use_excl,
                               a.excl_cos, &d, &s, &x, &y))
        top.offer(d, i, en.pl);
      k += dk;
      c += dc;
      if (k >= Kc) {
        k -= Kc;
        ++c;
      }
    }
  }
  // every lane of the warp takes part in the shuffles, live or not
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) top.template merge_xor<G>(off);
  if (!live || gl >= M) return;
  // lane m < M recomputes and stores the m-th winner from its entry (the
  // same arithmetic that ranked it, so the same values)
  float dm = eg3d::BIG;
  int im = -1, pm = -1;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (m == gl) {
      dm = top.d[m];
      im = top.idx[m];
      pm = top.pl[m];
    }
  }
  const bool ok = dm < eg3d::BIG * 0.5f && pm >= 0;
  int seg = 0;
  float t = 0.f, x = 0.f, y = 0.f;
  if (ok) {
    const int c = im / Kc, k = im - c * Kc, r = c / 5;
    const int yy = eg3d::clampi(cy + r - 2, 0, a.GH - 1);
    const int xx = eg3d::clampi(cx + (c - 5 * r) - 2, 0, a.GW - 1);
    eg3d::Entry en;
    float d;
    eg3d::load_entry(vg + ((yy * a.GW + xx) * Kc + k) * 6, &en);
    eg3d::epipolar_entry(en, ox, oy, l0, l1, l2, rad, a.use_excl,
                         a.excl_cos, &d, &t, &x, &y);
    seg = en.seg;
  }
  const int64_t o = q * M + gl;
  a.pl[o] = ok ? pm : -1;
  a.seg[o] = seg;
  a.t[o] = t;
  a.xy[2 * o] = x;
  a.xy[2 * o + 1] = y;
  a.dist[o] = ok ? dm : eg3d::BIG;
  a.valid[o] = ok ? 1 : 0;
}

template <int M>
int launch(const K2Args& a, int one_thread, cudaStream_t stream) {
  const int threads = 128;
  const int64_t lanes = (int64_t)a.Q * (one_thread ? 1 : LANES);
  const int blocks = (int)((lanes + threads - 1) / threads);
  if (one_thread)
    epipolar_topm_kernel<M><<<blocks, threads, 0, stream>>>(a);
  else
    epipolar_topm_group_kernel<M><<<blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eg3d_epipolar_topm(const float* grids, int V, int GH, int GW,
                                  int Kc, const int* view, const float* pts,
                                  const float* lines, const float* radius,
                                  const int* order, int Q, float cell, int M,
                                  int one_thread, int use_excl,
                                  float excl_cos,
                                  int* pl, int* seg, float* t, float* xy,
                                  float* dist, uint8_t* valid, void* stream) {
  (void)V;
  const K2Args a{grids, GH, GW, Kc, view, pts, lines, radius, order, Q, cell,
                 use_excl, excl_cos, pl, seg, t, xy, dist, valid};
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: return launch<1>(a, one_thread, s);
    case 2: return launch<2>(a, one_thread, s);
    case 4: return launch<4>(a, one_thread, s);
    case 8: return launch<8>(a, one_thread, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
