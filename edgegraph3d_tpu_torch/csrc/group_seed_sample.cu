// K6 group_seed_sample — interval samples of the match-set members and
// their epipolar crossings with the other members (stages 1 and 2).
//
// Replaces (JAX): the sampling and intersection half of
//   edgegraph3d_tpu/matching/polyline_stages.py `_group_seed_sweep`
//   (:434-469, part of XLA program B12): ops/polyline_ops.py
//   sample_interval_points (a scan of advance_by_distance) over every
//   member, the normalized epipolar lines F[cam_k, cam_j] [x, y, 1] (in
//   the FMA form XLA's CPU dot gives them, common.cuh epipolar_fma), and
//   polyline_line_intersections (the first two crossings in segment
//   order) of each line with member j's polyline.
//
// One block per (group, member) lane.  The block stages the group's K
// member polylines (already gathered by K5 into [G, K, L, 2]) in shared
// memory.  Thread 0 walks the lane's `S` samples: the first at coords[0],
// then S - 1 forward steps of `spacing` px (common.cuh advance, the
// multiply-adds XLA's CPU code fuses in the JAX scan, so the samples
// equal JAX's bit for bit); a lane keeps its last position once a step
// fails.  Then the block's threads
// take the (sample, member j) pairs: the epipolar line of the sample into
// member j's view, then a scan over j's segments with common.cuh seg_line
// that keeps the first two crossings.  Slots past the last crossing hold
// the first non-crossing segments in index order, as the reference's
// stable argsort does, with ok = 0.  i_ok also carries the reference's
// masks: member j valid, on another camera than the lane, sample valid.
//
// Bound on the H100: latency of the sequential walk (23 dependent steps
// per lane, one thread), then arithmetic of S * K * (L - 1) segment tests
// per lane from shared memory.  A stage-1 chunk has 64 x 8 lanes, so the
// card is far from full; the design keeps every read on chip.

#include "common.cuh"

namespace {

__global__ void group_seed_sample_kernel(
    const float* __restrict__ coords, const int* __restrict__ lengths,
    const int* __restrict__ cams, const uint8_t* __restrict__ mask, int K,
    int L, const float* __restrict__ F_table, int V, int S, float spacing,
    float qcos, float qdist, float* s_xy, int* s_seg, float* s_t,
    uint8_t* s_valid, float* i_xy, int* i_seg, float* i_t, uint8_t* i_ok) {
  extern __shared__ float smem[];
  const int64_t lane = blockIdx.x;  // g * K + k
  const int64_t g = lane / K;
  const int k = (int)(lane % K);
  float* c_sh = smem;             // [K, L, 2]
  float* sx = c_sh + K * L * 2;   // [S]
  float* sy = sx + S;             // [S]
  int* len_sh = (int*)(sy + S);   // [K]
  int* cam_sh = len_sh + K;       // [K]
  int* msk_sh = cam_sh + K;       // [K]
  int* sv_sh = msk_sh + K;        // [S]

  const float* gc = coords + g * K * L * 2;
  for (int i = threadIdx.x; i < K * L * 2; i += blockDim.x) c_sh[i] = gc[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    len_sh[i] = lengths[g * K + i];
    cam_sh[i] = cams[g * K + i];
    msk_sh[i] = mask[g * K + i];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const eg3d::Poly p{c_sh + k * L * 2, len_sh[k]};
    int seg = 0;
    float t = 0.0f, x = p.c[0], y = p.c[1];
    bool alive = p.len >= 2;
    for (int i = 0; i < S; ++i) {
      if (i > 0 && alive) {
        int ns;
        float nt, nx, ny;
        alive = eg3d::advance(p, seg, x, y, 1, spacing, &ns, &nt, &nx, &ny);
        if (alive) {
          seg = ns;
          t = nt;
          x = nx;
          y = ny;
        }
      }
      const int64_t o = lane * S + i;
      const bool v = alive && msk_sh[k] != 0;
      s_xy[2 * o] = x;
      s_xy[2 * o + 1] = y;
      s_seg[o] = seg;
      s_t[o] = t;
      s_valid[o] = v ? 1 : 0;
      sx[i] = x;
      sy[i] = y;
      sv_sh[i] = v ? 1 : 0;
    }
  }
  __syncthreads();

  const int cam_k = cam_sh[k] < 0 ? 0 : cam_sh[k];
  for (int w = threadIdx.x; w < S * K; w += blockDim.x) {
    const int i = w / K;
    const int j = w % K;
    const int cam_j = cam_sh[j] < 0 ? 0 : cam_sh[j];
    float l0, l1, l2;
    eg3d::epipolar_fma(F_table + ((int64_t)cam_k * V + cam_j) * 9, sx[i],
                       sy[i], &l0, &l1, &l2);
    const float* pc = c_sh + j * L * 2;
    const int len = len_sh[j];
    int hit_seg[2] = {0, 0}, miss_seg[2] = {0, 0};
    float hit_s[2] = {0.f, 0.f}, miss_s[2] = {0.f, 0.f};
    int n_hit = 0, n_miss = 0;
    for (int q = 0; q < L - 1 && n_hit < 2; ++q) {
      const eg3d::SegLine r = eg3d::seg_line(pc[2 * q], pc[2 * q + 1],
                                             pc[2 * q + 2], pc[2 * q + 3],
                                             l0, l1, l2, qcos, qdist);
      if (r.has && q < len - 1) {
        hit_seg[n_hit] = q;
        hit_s[n_hit] = r.s;
        ++n_hit;
      } else if (n_miss < 2) {
        miss_seg[n_miss] = q;
        miss_s[n_miss] = r.s;
        ++n_miss;
      }
    }
    const bool usable = msk_sh[j] != 0 && cam_sh[j] != cam_sh[k] &&
                        sv_sh[i] != 0;
    const int64_t o = ((lane * S + i) * K + j) * 2;
    for (int m = 0; m < 2; ++m) {
      const bool hit = m < n_hit;
      const int q = hit ? hit_seg[m] : miss_seg[m - n_hit];
      const float s = hit ? hit_s[m] : miss_s[m - n_hit];
      const float ax = pc[2 * q], ay = pc[2 * q + 1];
      i_xy[2 * (o + m)] = ax + s * (pc[2 * q + 2] - ax);
      i_xy[2 * (o + m) + 1] = ay + s * (pc[2 * q + 3] - ay);
      i_seg[o + m] = q;
      i_t[o + m] = s;
      i_ok[o + m] = (hit && usable) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int eg3d_group_seed_sample_smem(int K, int L, int S) {
  return (K * L * 2 + 2 * S) * (int)sizeof(float) +
         (3 * K + S) * (int)sizeof(int);
}

extern "C" int eg3d_group_seed_sample(
    const float* coords, const int* lengths, const int* cams,
    const uint8_t* mask, int G, int K, int L, const float* F_table, int V,
    int S, float spacing, float qcos, float qdist, float* s_xy, int* s_seg,
    float* s_t, uint8_t* s_valid, float* i_xy, int* i_seg, float* i_t,
    uint8_t* i_ok, void* stream) {
  if (G <= 0 || K <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const size_t smem = (size_t)eg3d_group_seed_sample_smem(K, L, S);
  group_seed_sample_kernel<<<(unsigned)(G * K), threads, smem,
                             (cudaStream_t)stream>>>(
      coords, lengths, cams, mask, K, L, F_table, V, S, spacing, qcos, qdist,
      s_xy, s_seg, s_t, s_valid, i_xy, i_seg, i_t, i_ok);
  return (int)cudaGetLastError();
}
