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
// One block per group.  The block places the group's K member polylines
// (already gathered by K5 into [G, K, L, 2]) with their lengths, cameras
// and masks, K * (8 L + 12) bytes, as kernels.table_placement says: in
// shared memory (opted in above 48 KiB), or, beyond the card's opt-in
// limit, read from device memory through the read-only path by the same
// body (kGlobal).
//
// Walk.  Member k's lane walks its S samples: the first at coords[0],
// then S - 1 forward steps of `spacing` px (common.cuh advance, the
// multiply-adds XLA's CPU code fuses in the JAX scan, so the samples
// equal JAX's bit for bit only in this step-after-step form); a lane
// keeps its last position once a step fails.  The samples go straight to
// s_xy / s_valid, which the block reads back after __syncthreads().
//
// Crossings.  The block's threads take the S * K * K (sample of member k,
// member j) pairs member-major, so a warp's pairs share member j and its
// scan bound.  Each thread computes its pair's epipolar line and scans j's
// segments below len - 1 (common.cuh seg_line) until two crossings; slots
// past the last crossing hold the lowest non-crossing segments (0 and 1,
// or the one of 0, 1 that is not the crossing), exactly what the
// reference's stable argsort picks, with ok = 0.  Segments from len - 1
// on never cross, so the scan stops there.  i_ok also carries the reference's masks: member j valid, on
// another camera than member k, the sample valid.
//
// A warp per pair, its segments split over the lanes and the two hits
// picked by __ballot_sync, measured 4.5x slower on an H100 than this
// thread per pair (0.0858 against 0.0189 ms at phase 2's shape,
// PERF.md): a pair costs ~70 issued warp instructions of broadcast,
// ballot and selection for ~20 segment tests, and the 64 groups of a
// stage-1 chunk give too few warps to hide that chain.
//
// Bound on the H100: latency.  The walk is a chain of dependent steps per
// member; the pairs cost ~25 operations per segment test, and the bytes
// that must move are small.  A stage-1 chunk has 64 groups, so half the
// card's SMs take a block and the rest idle.

#include "common.cuh"

namespace {

constexpr int WARPS = 16;  // warps per block

// The group's member table in shared memory.
struct SharedMembers {
  const float* c;  // [K, L, 2]
  const int* len;
  const int* cam;
  const int* msk;
  __device__ __forceinline__ int length(int j) const { return len[j]; }
  __device__ __forceinline__ int camera(int j) const { return cam[j]; }
  __device__ __forceinline__ bool valid(int j) const { return msk[j] != 0; }
};

// The group's member table in device memory.
struct GlobalMembers {
  eg3d::Ldg c;  // [K, L, 2]
  const int* len;
  const int* cam;
  const uint8_t* msk;
  __device__ __forceinline__ int length(int j) const { return __ldg(len + j); }
  __device__ __forceinline__ int camera(int j) const { return __ldg(cam + j); }
  __device__ __forceinline__ bool valid(int j) const {
    return __ldg(msk + j) != 0;
  }
};

struct Outputs {
  float* s_xy;
  int* s_seg;
  float* s_t;
  uint8_t* s_valid;
  float* i_xy;
  int* i_seg;
  float* i_t;
  uint8_t* i_ok;
};

// The walk: one lane per member.
template <class Members>
__device__ __forceinline__ void walk_members(const Members m, int64_t g,
                                             int K, int L, int S,
                                             float spacing, const Outputs o) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const eg3d::PolyT<decltype(m.c)> p{m.c + (int64_t)k * L * 2, m.length(k)};
    const bool member = m.valid(k);
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
      const int64_t r = (g * K + k) * S + i;
      o.s_xy[2 * r] = x;
      o.s_xy[2 * r + 1] = y;
      o.s_seg[r] = seg;
      o.s_t[r] = t;
      o.s_valid[r] = (alive && member) ? 1 : 0;
    }
  }
  __syncthreads();  // the samples written above are visible to the block
}

// Write pair p's two slots (segment, crossing parameter, hit) of member
// j's polyline pc: xy = a + s (b - a), and ok = hit && usable.
template <class Tab>
__device__ __forceinline__ void write_pair(const Outputs& o, int64_t out,
                                           const Tab pc, int q0, float s0,
                                           int q1, float s1, int n_hit,
                                           bool usable) {
  const float ax0 = pc[2 * q0], ay0 = pc[2 * q0 + 1];
  const float ax1 = pc[2 * q1], ay1 = pc[2 * q1 + 1];
  reinterpret_cast<float4*>(o.i_xy)[out] = make_float4(
      ax0 + s0 * (pc[2 * q0 + 2] - ax0), ay0 + s0 * (pc[2 * q0 + 3] - ay0),
      ax1 + s1 * (pc[2 * q1 + 2] - ax1), ay1 + s1 * (pc[2 * q1 + 3] - ay1));
  reinterpret_cast<int2*>(o.i_seg)[out] = make_int2(q0, q1);
  reinterpret_cast<float2*>(o.i_t)[out] = make_float2(s0, s1);
  reinterpret_cast<uchar2*>(o.i_ok)[out] = make_uchar2(
      (n_hit > 0 && usable) ? 1 : 0, (n_hit > 1 && usable) ? 1 : 0);
}

// The pairs, one thread each, member-major (a warp's pairs share member j,
// so its scans share a bound): the first two crossings below len - 1 in
// segment order, then the first non-crossing segments as fill slots.
template <class Members>
__device__ __forceinline__ void pairs(
    const Members m, int64_t g, int K, int L, const float* __restrict__ F_table,
    int V, int S, float qcos, float qdist, const Outputs o) {
  const int n_ki = K * S;
  const int n_pairs = n_ki * K;
  for (int t = threadIdx.x; t < n_pairs; t += blockDim.x) {
    const int j = t / n_ki;
    const int ki = t % n_ki;  // k * S + i
    const int k = ki / S;
    const int64_t r = g * n_ki + ki;
    const int cam_k = m.camera(k), cam_j = m.camera(j);
    const int ck = cam_k < 0 ? 0 : cam_k;
    const int cj = cam_j < 0 ? 0 : cam_j;
    float l0, l1, l2;
    eg3d::epipolar_fma(eg3d::Ldg{F_table + ((int64_t)ck * V + cj) * 9},
                       o.s_xy[2 * r], o.s_xy[2 * r + 1], &l0, &l1, &l2);
    const bool usable = m.valid(j) && cam_j != cam_k && o.s_valid[r] != 0;
    const auto pc = m.c + (int64_t)j * L * 2;
    const int len = m.length(j);
    int q0 = 0, q1 = 0, n_hit = 0;
    float s0 = 0.0f, s1 = 0.0f;
    for (int q = 0; q < len - 1 && n_hit < 2; ++q) {
      const auto sl = eg3d::seg_line(pc[2 * q], pc[2 * q + 1],
                                     pc[2 * q + 2], pc[2 * q + 3], l0, l1,
                                     l2, qcos, qdist);
      if (sl.has) {
        if (n_hit == 0) { q0 = q; s0 = sl.s; } else { q1 = q; s1 = sl.s; }
        ++n_hit;
      }
    }
    // fill slots: the lowest segments that hold no crossing
    if (n_hit < 2) {
      const int f0 = (n_hit == 1 && q0 == 0) ? 1 : 0;
      const int f = n_hit == 0 ? 1 : f0;
      const float sf = eg3d::seg_line(pc[2 * f], pc[2 * f + 1], pc[2 * f + 2],
                                      pc[2 * f + 3], l0, l1, l2, qcos,
                                      qdist).s;
      if (n_hit == 0) {
        q0 = 0;
        s0 = eg3d::seg_line(pc[0], pc[1], pc[2], pc[3], l0, l1, l2, qcos,
                            qdist).s;
      }
      q1 = f;
      s1 = sf;
    }
    write_pair(o, g * n_pairs + (int64_t)ki * K + j, pc, q0, s0, q1, s1,
               n_hit, usable);
  }
}

template <class Members>
__device__ __forceinline__ void group_body(
    const Members m, int64_t g, int K, int L, const float* __restrict__ F_table,
    int V, int S, float spacing, float qcos, float qdist, const Outputs o) {
  walk_members(m, g, K, L, S, spacing, o);
  pairs(m, g, K, L, F_table, V, S, qcos, qdist, o);
}

template <bool kGlobal>
__global__ void __launch_bounds__(WARPS * 32)
    group_seed_sample_kernel(const float* __restrict__ coords,
                             const int* __restrict__ lengths,
                             const int* __restrict__ cams,
                             const uint8_t* __restrict__ mask, int K, int L,
                             const float* __restrict__ F_table, int V, int S,
                             float spacing, float qcos, float qdist,
                             Outputs o) {
  const int64_t g = blockIdx.x;
  const float* gc = coords + g * K * L * 2;
  if constexpr (kGlobal) {
    group_body(GlobalMembers{eg3d::Ldg{gc}, lengths + g * K, cams + g * K,
                             mask + g * K},
               g, K, L, F_table, V, S, spacing, qcos, qdist, o);
  } else {
    extern __shared__ float smem[];
    float* c_sh = smem;                         // [K, L, 2]
    int* len_sh = (int*)(c_sh + K * L * 2);     // [K]
    int* cam_sh = len_sh + K;                   // [K]
    int* msk_sh = cam_sh + K;                   // [K]
    for (int i = threadIdx.x; i < K * L * 2; i += blockDim.x)
      c_sh[i] = gc[i];
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      len_sh[i] = lengths[g * K + i];
      cam_sh[i] = cams[g * K + i];
      msk_sh[i] = mask[g * K + i];
    }
    __syncthreads();
    group_body(SharedMembers{c_sh, len_sh, cam_sh, msk_sh}, g, K, L, F_table,
               V, S, spacing, qcos, qdist, o);
  }
}

// Bytes of one block's member table (polyline_stages.k6_table_bytes).
int smem_bytes(int K, int L) {
  return K * L * 2 * (int)sizeof(float) + 3 * K * (int)sizeof(int);
}

int launch(const float* coords, const int* lengths, const int* cams,
           const uint8_t* mask, int G, int K, int L, const float* F_table,
           int V, int S, float spacing, float qcos, float qdist, int place,
           const Outputs& o, cudaStream_t s) {
  if (place == 2) {
    group_seed_sample_kernel<true><<<(unsigned)G, WARPS * 32, 0, s>>>(
        coords, lengths, cams, mask, K, L, F_table, V, S, spacing, qcos,
        qdist, o);
    return (int)cudaGetLastError();
  }
  const int smem = smem_bytes(K, L);
  if (place == 0 && smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (place == 1) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_seed_sample_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  group_seed_sample_kernel<false><<<(unsigned)G, WARPS * 32, smem, s>>>(
      coords, lengths, cams, mask, K, L, F_table, V, S, spacing, qcos, qdist,
      o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eg3d_group_seed_sample_smem(int K, int L, int S) {
  (void)S;
  return smem_bytes(K, L);
}

// place: 0 the member table in at most 48 KiB of shared memory, 1 in
// opted-in shared memory, 2 in device memory (kernels.py table_placement).
extern "C" int eg3d_group_seed_sample(
    const float* coords, const int* lengths, const int* cams,
    const uint8_t* mask, int G, int K, int L, const float* F_table, int V,
    int S, float spacing, float qcos, float qdist, int place, float* s_xy, int* s_seg, float* s_t, uint8_t* s_valid, float* i_xy,
    int* i_seg, float* i_t, uint8_t* i_ok, void* stream) {
  if (G <= 0 || K <= 0) return (int)cudaSuccess;
  if (L < 3 || S < 1) return (int)cudaErrorInvalidValue;
  const Outputs o{s_xy, s_seg, s_t, s_valid, i_xy, i_seg, i_t, i_ok};
  cudaStream_t s = (cudaStream_t)stream;
  return launch(coords, lengths, cams, mask, G, K, L, F_table, V, S, spacing,
                qcos, qdist, place, o, s);
}
