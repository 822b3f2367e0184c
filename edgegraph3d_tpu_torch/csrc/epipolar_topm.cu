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
// quasi-parallel segments), and keep the top-M distinct polylines.
//
// Bound on the H100: 25 cells x 8 entries x 24 B = 4.8 KB of gathered
// grid per query against ~30 flops per entry — a gather-latency-bound
// kernel.  Queries are issued start-major (all target views of one start
// are adjacent), so a warp reads up to 32 different views' grids; the
// 49-view grid set at 1600x1200 is ~180 MB, more than the 50 MB L2, so
// reuse across queries is partial.  No shared-memory staging yet.

#include "common.cuh"

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
  const int cx = eg3d::cell_of(ox, cell, GW);
  const int cy = eg3d::cell_of(oy, cell, GH);
  eg3d::TopM<M> top;
  top.init();
  for (int dy = -2; dy <= 2; ++dy) {
    const int yy = eg3d::clampi(cy + dy, 0, GH - 1);
    for (int dx = -2; dx <= 2; ++dx) {
      const int xx = eg3d::clampi(cx + dx, 0, GW - 1);
      const float* e = grids + (((v * GH + yy) * GW + xx) * Kc) * 6;
      for (int k = 0; k < Kc; ++k, e += 6) {
        const int pl = (int)e[0];
        if (pl < 0) continue;
        const float ax = e[2], ay = e[3], bx = e[4], by = e[5];
        const float sa = ax * l0 + ay * l1 + l2;
        const float sb = bx * l0 + by * l1 + l2;
        const float diff = sa - sb;
        const bool parallel = fabsf(diff) < 1e-9f;
        const float s = parallel ? 0.0f : sa / diff;
        bool crosses = (sa * sb <= 0.0f) && !parallel && (s >= 0.0f) &&
                       (s <= 1.0f);
        const float abx = bx - ax;
        const float aby = by - ay;
        if (use_excl) {
          const float len = eg3d::nmax(sqrtf(abx * abx + aby * aby), 1e-12f);
          const float c = fabsf(abx * (-l1) + aby * l0) / len;
          crosses = crosses && (c < excl_cos);
        }
        if (!crosses) continue;
        const float x = ax + s * abx;
        const float y = ay + s * aby;
        const float ex = x - ox;
        const float ey = y - oy;
        const float d = sqrtf(ex * ex + ey * ey);
        if (d <= rad) top.offer(d, pl, (int)e[1], s, x, y);
      }
    }
  }
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
