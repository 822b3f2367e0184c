// K1 grid_topm_query — nearby-polyline candidates from the segment grid.
//
// Replaces (JAX): edgegraph3d_tpu/matching/detection.py
//   detect_starting_intersections (with grid.gather_neighborhood,
//   grid.point_segment_distance and _topm_distinct), vmapped over
//   queries inside refpoints._start_sweep, refpoints._locate_on_polylines
//   and expansion._expand_candidates.
//
// One thread per query: read the 3x3 cells around the point (clipped at
// the image border, so border cells repeat exactly as the reference's
// gather does), 8 entries (pl, seg, ax, ay, bx, by) per cell, take the
// point-segment distance, keep entries within `radius`, and insert them
// into a register top-M of distinct polylines (common.cuh).  The query
// body is grid_query.cuh grid_topm_one, which K7 shares.
//
// Bound on the H100: a query reads 9 cells x 8 entries x 24 B = 1.7 KB
// of grid with data-dependent addresses and does ~20 flops per entry,
// so it is bound by L2/DRAM gather latency, not arithmetic.  Neighbouring
// queries (consecutive refpoints / chain points) hit neighbouring cells,
// so most reads come from L2; no shared-memory staging yet.

#include "grid_query.cuh"

namespace {

template <int M>
__global__ void grid_topm_kernel(const float* __restrict__ grids, int GH,
                                 int GW, int Kc,
                                 const int* __restrict__ view,
                                 const float* __restrict__ pts, int Q,
                                 float cell, float radius, int* pl_out,
                                 int* seg_out, float* t_out, float* xy_out,
                                 float* dist_out, uint8_t* valid_out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int64_t v = view[q];
  const float px = pts[2 * q];
  const float py = pts[2 * q + 1];
  eg3d::TopM<M> top;
  eg3d::grid_topm_one<M>(grids, GH, GW, Kc, v, px, py, cell, radius, top);
  top.store(q, pl_out, seg_out, t_out, xy_out, dist_out, valid_out);
}

template <int M>
void launch(const float* grids, int GH, int GW, int Kc, const int* view,
            const float* pts, int Q, float cell, float radius, int* pl,
            int* seg, float* t, float* xy, float* dist, uint8_t* valid,
            cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  grid_topm_kernel<M><<<blocks, threads, 0, stream>>>(
      grids, GH, GW, Kc, view, pts, Q, cell, radius, pl, seg, t, xy, dist,
      valid);
}

}  // namespace

extern "C" int eg3d_grid_topm(const float* grids, int V, int GH, int GW,
                              int Kc, const int* view, const float* pts,
                              int Q, float cell, float radius, int M,
                              int* pl, int* seg, float* t, float* xy,
                              float* dist, uint8_t* valid, void* stream) {
  (void)V;
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: launch<1>(grids, GH, GW, Kc, view, pts, Q, cell, radius, pl, seg, t, xy, dist, valid, s); break;
    case 2: launch<2>(grids, GH, GW, Kc, view, pts, Q, cell, radius, pl, seg, t, xy, dist, valid, s); break;
    case 3: launch<3>(grids, GH, GW, Kc, view, pts, Q, cell, radius, pl, seg, t, xy, dist, valid, s); break;
    case 4: launch<4>(grids, GH, GW, Kc, view, pts, Q, cell, radius, pl, seg, t, xy, dist, valid, s); break;
    case 8: launch<8>(grids, GH, GW, Kc, view, pts, Q, cell, radius, pl, seg, t, xy, dist, valid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
