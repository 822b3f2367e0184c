// K2 epipolar_topm_query — epipolar-line correspondences from the grid.
//
// Replaces (JAX): edgegraph3d_tpu/matching/detection.py
//   detect_epipolar_correspondences (5x5 grid.gather_neighborhood +
//   segment x line intersection + _topm_distinct), vmapped over the
//   compacted starts x target views in refpoints._seed_from_starts and
//   over chain points in expansion._expand_candidates ("epipolar" mode).
//
// One thread per query: read the 5x5 cells around the observation,
// intersect every entry's segment with the query's normalized line,
// keep crossings within the query's radius (optionally dropping
// quasi-parallel segments), and keep the top-M distinct polylines.  The
// query body is grid_query.cuh epipolar_topm_one, which K7 shares.
//
// Bound on the H100: 25 cells x 8 entries x 24 B = 4.8 KB of gathered
// grid per query against ~30 flops per entry — a gather-latency-bound
// kernel.  Queries are issued start-major (all target views of one start
// are adjacent), so a warp reads up to 32 different views' grids; the
// 49-view grid set at 1600x1200 is ~180 MB, more than the 50 MB L2, so
// reuse across queries is partial.  No shared-memory staging yet.

#include "grid_query.cuh"

namespace {

template <int M>
__global__ void epipolar_topm_kernel(
    const float* __restrict__ grids, int GH, int GW, int Kc,
    const int* __restrict__ view, const float* __restrict__ pts,
    const float* __restrict__ lines, const float* __restrict__ radius, int Q,
    float cell, int use_excl, float excl_cos, int* pl_out, int* seg_out,
    float* t_out, float* xy_out, float* dist_out, uint8_t* valid_out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int64_t v = view[q];
  const float ox = pts[2 * q];
  const float oy = pts[2 * q + 1];
  const float l0 = lines[3 * q];
  const float l1 = lines[3 * q + 1];
  const float l2 = lines[3 * q + 2];
  const float rad = radius[q];
  eg3d::TopM<M> top;
  eg3d::epipolar_topm_one<M>(grids, GH, GW, Kc, v, ox, oy, l0, l1, l2, rad,
                             cell, use_excl, excl_cos, top);
  top.store(q, pl_out, seg_out, t_out, xy_out, dist_out, valid_out);
}

template <int M>
void launch(const float* grids, int GH, int GW, int Kc, const int* view,
            const float* pts, const float* lines, const float* radius, int Q,
            float cell, int use_excl, float excl_cos, int* pl, int* seg,
            float* t, float* xy, float* dist, uint8_t* valid,
            cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  epipolar_topm_kernel<M><<<blocks, threads, 0, stream>>>(
      grids, GH, GW, Kc, view, pts, lines, radius, Q, cell, use_excl,
      excl_cos, pl, seg, t, xy, dist, valid);
}

}  // namespace

extern "C" int eg3d_epipolar_topm(const float* grids, int V, int GH, int GW,
                                  int Kc, const int* view, const float* pts,
                                  const float* lines, const float* radius,
                                  int Q, float cell, int M, int use_excl,
                                  float excl_cos, int* pl, int* seg, float* t,
                                  float* xy, float* dist, uint8_t* valid,
                                  void* stream) {
  (void)V;
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: launch<1>(grids, GH, GW, Kc, view, pts, lines, radius, Q, cell, use_excl, excl_cos, pl, seg, t, xy, dist, valid, s); break;
    case 2: launch<2>(grids, GH, GW, Kc, view, pts, lines, radius, Q, cell, use_excl, excl_cos, pl, seg, t, xy, dist, valid, s); break;
    case 4: launch<4>(grids, GH, GW, Kc, view, pts, lines, radius, Q, cell, use_excl, excl_cos, pl, seg, t, xy, dist, valid, s); break;
    case 8: launch<8>(grids, GH, GW, Kc, view, pts, lines, radius, Q, cell, use_excl, excl_cos, pl, seg, t, xy, dist, valid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
