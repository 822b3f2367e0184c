// K7 expand_chains — the whole per-view expansion loop of one chunk of
// chains in one launch.
//
// Replaces (JAX): edgegraph3d_tpu/matching/expansion.py
//   expand_chains_compact, the jitted lax.scan over views (`per_view`
//   at :361), with _expand_candidates and _monotone_runs (B7 in the
//   ROADMAP).  The port ran it as a Python loop over views around K1 and
//   K3 with a host sync per view (expansion._expand_chains_compact_plain,
//   the plain version this kernel is held against).
//
// For each view v in order, every chain point: project X through P[v];
// find the unique-within-tol candidate (K1's query at M = 2, plus K2's
// at M = 4 with the same-polyline substitution in "epipolar" mode);
// c_ok = unique & depth > 0 & v not a tuple view; keep it only inside a
// same-polyline monotone run along the chain (>= 3 points, >= 2 touching
// a chain end, any point of a chain of <= 2); put it in the first free
// observation slot and run the warm-started GN; on acceptance update X,
// the observation buffer and out_xy / out_ok.
//
// Design.  One warp per chain (T <= 64 slots): lane l owns slots l and
// l + 32, several chains per block.  The view loop runs inside the
// kernel, since it is sequential per chain (the run test couples the
// chain's points within a view, and an accepted observation moves X
// before the next view) while chains are independent: a chunk is one
// launch, with no per-view launch, nonzero or host sync.  The run test's
// prefix max (run start) and suffix min (run end) over the 64 slots are
// integer warp scans with __shfl_*_sync across the two halves: exact, no
// shared memory, no [C, T] scatter in device memory.  P [V, 3, 4] and, in
// "epipolar" mode, each chain's F_table[vs, :] rows sit in shared
// memory.  The candidate queries and the GN are the very device code of
// K1, K2 and K3 (grid_query.cuh, gn.cuh), so every decision has the same
// arithmetic in the same order as the plain version.  The GN runs over
// the live observations only: slots fill in view order and are never
// freed, so a point's live observations are a prefix of its buffer, and
// the masked tail the plain version carries adds exact zeros.  The
// [K, Omax] observation buffers live in device memory; a lane reads only
// its points' live prefixes.  A query is skipped where its result cannot
// matter (a tuple view, depth <= 0, no unique candidate).
//
// Bound on the H100: operations and latency.  Per (point, view) the K1
// query reads 9 cells x 8 entries (1.7 KB of grid, L2-resident per
// neighbourhood), and a candidate that passes the run test costs up to
// follow_gn_iters GN iterations of ~85 flops per live observation (the
// per-item costs chip_smoke.py counts).  The bytes that must
// move are small (X, obs3 and the [K, V] outputs), so the floor is the
// flops over 67 TFLOP/s; the sequential view loop and the idle lanes of
// short chains (chains fill ~15-20 % of their 64 slots) keep the kernel
// well above it.

#include "gn.cuh"
#include "grid_query.cuh"

namespace {

constexpr int WARPS = 4;  // chains per block
constexpr unsigned FULL = 0xffffffffu;

// Observation o of one point during expansion: the first n from its
// [Omax] buffer row, then the candidate of the current view.
struct ExpansionObs {
  const int* cam;
  const float* x;
  const float* y;
  int n;
  int v_new;
  float x_new, y_new;
  __device__ __forceinline__ void operator()(int o, int* c, float* ox,
                                             float* oy, float* m) const {
    if (o < n) {
      *c = cam[o];
      *ox = x[o];
      *oy = y[o];
    } else {
      *c = v_new;
      *ox = x_new;
      *oy = y_new;
    }
    *m = 1.0f;
  }
};

// torch.sign for a float: -1, 0, 1 (NaN stays NaN)
__device__ __forceinline__ float sgn(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);
}

__global__ void expand_chains_kernel(
    const float* __restrict__ grids, int V, int GH, int GW, int Kc,
    float cell, const float* __restrict__ P_mats,
    const float* __restrict__ F_table, const float* __restrict__ obs3,
    const int* __restrict__ cams3, const int* __restrict__ slot_k,
    const uint8_t* __restrict__ chain_valid, int C, int T, int Omax,
    float tol, int epipolar, float qp_cos, int gn_iters, float gn_eps,
    float accept_mse, float det_min, float* X, int* cam_buf, float* obs_x,
    float* obs_y, float* out_xy, uint8_t* out_ok) {
  extern __shared__ float smem[];
  float* P_sh = smem;                         // [V, 12]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* F_sh = P_sh + V * 12 + warp * V * 9;  // [V, 9] of this chain
  for (int i = threadIdx.x; i < V * 12; i += blockDim.x) P_sh[i] = P_mats[i];
  const int64_t c = (int64_t)blockIdx.x * WARPS + warp;
  const bool live_chain = c < C;
  int cam0 = 0, cam1 = 0, cam2 = 0;
  if (live_chain) {
    cam0 = cams3[3 * c];
    cam1 = cams3[3 * c + 1];
    cam2 = cams3[3 * c + 2];
    if (epipolar) {
      const float* Fr = F_table + (int64_t)cam0 * V * 9;
      for (int i = lane; i < V * 9; i += 32) F_sh[i] = Fr[i];
    }
  }
  __syncthreads();
  if (!live_chain) return;

  // the lane's two slots t = lane + 32 s
  int64_t kk[2];
  bool has[2], cv[2];
  float px3[2], py3[2], pz3[2], dx0[2], dy0[2];
  int nob[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = lane + 32 * s;
    kk[s] = (t < T) ? (int64_t)slot_k[c * T + t] : -1;
    cv[s] = (t < T) && chain_valid[c * T + t] != 0;
    has[s] = kk[s] >= 0;
    px3[s] = py3[s] = pz3[s] = dx0[s] = dy0[s] = 0.0f;
    nob[s] = 0;
    if (has[s]) {
      const int64_t k = kk[s];
      px3[s] = X[3 * k];
      py3[s] = X[3 * k + 1];
      pz3[s] = X[3 * k + 2];
      dx0[s] = obs3[6 * k];
      dy0[s] = obs3[6 * k + 1];
      const int cr[3] = {cam0, cam1, cam2};
      for (int j = 0; j < 3; ++j) {
        cam_buf[k * Omax + j] = cr[j];
        obs_x[k * Omax + j] = obs3[6 * k + 2 * j];
        obs_y[k * Omax + j] = obs3[6 * k + 2 * j + 1];
      }
      nob[s] = 3;
    }
  }
  // chain extent: n_chain, first and last valid slot
  const unsigned long long vm =
      (unsigned long long)__ballot_sync(FULL, cv[0]) |
      ((unsigned long long)__ballot_sync(FULL, cv[1]) << 32);
  const bool short_chain = __popcll(vm) <= 2;
  const int first_valid = vm ? __ffsll((long long)vm) - 1 : T + 1;
  const int last_valid = vm ? 63 - __clzll((long long)vm) : -1;

  for (int v = 0; v < V; ++v) {
    if (v == cam0 || v == cam1 || v == cam2) continue;  // c_ok all false
    const float* Pv = P_sh + v * 12;
    int cpl[2];
    float cpos[2], cx[2], cy[2];
    bool cok[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      cpl[s] = -2;
      cpos[s] = 0.0f;
      cx[s] = cy[s] = 0.0f;
      cok[s] = false;
      if (!has[s]) continue;
      const float x = px3[s], y = py3[s], z = pz3[s];
      const float xH = Pv[0] * x + Pv[1] * y + Pv[2] * z + Pv[3];
      const float yH = Pv[4] * x + Pv[5] * y + Pv[6] * z + Pv[7];
      const float zH = Pv[8] * x + Pv[9] * y + Pv[10] * z + Pv[11];
      if (!(zH > 0.0f)) continue;
      const float zg = (fabsf(zH) < 1e-12f) ? 1e-12f : zH;
      const float qx = xH / zg;
      const float qy = yH / zg;
      eg3d::TopM<2> top;
      eg3d::grid_topm_one<2>(grids, GH, GW, Kc, v, qx, qy, cell, tol, top);
      if (!(top.ok(0) && !top.ok(1))) continue;
      const int pl = top.pl[0];
      int seg = top.seg[0];
      float tt = top.t[0], ex = top.x[0], ey = top.y[0];
      if (epipolar) {
        float l0, l1, l2;
        eg3d::epipolar(F_sh + v * 9, dx0[s], dy0[s], &l0, &l1, &l2);
        eg3d::TopM<4> ep;
        eg3d::epipolar_topm_one<4>(grids, GH, GW, Kc, v, qx, qy, l0, l1, l2,
                                   tol, cell, 1, qp_cos, ep);
        bool found = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!found && ep.ok(j) && ep.pl[j] == pl) {
            found = true;
            seg = ep.seg[j];
            tt = ep.t[j];
            ex = ep.x[j];
            ey = ep.y[j];
          }
        }
      }
      cpl[s] = pl;
      cpos[s] = (float)seg + tt;
      cx[s] = ex;
      cy[s] = ey;
      cok[s] = true;
    }

    // continuity: same-polyline locally monotone runs along the chain.
    // okc = candidate ok on a valid slot; base[t] = slots t-1 and t on
    // one polyline with a nonzero step; link[t] = base[t] continuing the
    // previous step's direction (or starting a run).
    const bool okc0 = cok[0] && cv[0], okc1 = cok[1] && cv[1];
    // slot t - 1: lane - 1's same slot, or lane 31's first slot for t = 32
    const int pl_up0 = __shfl_up_sync(FULL, cpl[0], 1);
    const int pl_up1 = __shfl_up_sync(FULL, cpl[1], 1);
    const int pl_31 = __shfl_sync(FULL, cpl[0], 31);
    const float pos_up0 = __shfl_up_sync(FULL, cpos[0], 1);
    const float pos_up1 = __shfl_up_sync(FULL, cpos[1], 1);
    const float pos_31 = __shfl_sync(FULL, cpos[0], 31);
    const bool ok_up0 = __shfl_up_sync(FULL, (int)okc0, 1) != 0;
    const bool ok_up1 = __shfl_up_sync(FULL, (int)okc1, 1) != 0;
    const bool ok_31 = __shfl_sync(FULL, (int)okc0, 31) != 0;
    const bool first = lane == 0;
    const int ppl1 = first ? pl_31 : pl_up1;
    const float ppos1 = first ? pos_31 : pos_up1;
    const bool pok1 = first ? ok_31 : ok_up1;
    const float d0 = cpos[0] - pos_up0;
    const float d1 = cpos[1] - ppos1;
    const bool base0 = !first && cpl[0] == pl_up0 && okc0 && ok_up0 &&
                       fabsf(d0) > 0.0f;
    const bool base1 = cpl[1] == ppl1 && okc1 && pok1 && fabsf(d1) > 0.0f;
    const float sg0 = sgn(d0), sg1 = sgn(d1);
    const bool b_up0 = __shfl_up_sync(FULL, (int)base0, 1) != 0;
    const bool b_up1 = __shfl_up_sync(FULL, (int)base1, 1) != 0;
    const bool b_31 = __shfl_sync(FULL, (int)base0, 31) != 0;
    const float s_up0 = __shfl_up_sync(FULL, sg0, 1);
    const float s_up1 = __shfl_up_sync(FULL, sg1, 1);
    const float s_31 = __shfl_sync(FULL, sg0, 31);
    const bool pb0 = !first && b_up0;
    const bool pb1 = first ? b_31 : b_up1;
    const float ps1 = first ? s_31 : s_up1;
    const bool link0 = base0 && (!pb0 || sg0 == s_up0);
    const bool link1 = base1 && (!pb1 || sg1 == ps1);

    // run start: prefix max of (link ? -1 : t), clamped at 0
    int a0 = link0 ? -1 : lane;
    int a1 = link1 ? -1 : lane + 32;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o0 = __shfl_up_sync(FULL, a0, off);
      const int o1 = __shfl_up_sync(FULL, a1, off);
      if (lane >= off) {
        a0 = max(a0, o0);
        a1 = max(a1, o1);
      }
    }
    a1 = max(a1, __shfl_sync(FULL, a0, 31));
    const int start0 = max(a0, 0), start1 = max(a1, 0);
    // run end: suffix min of (link[t + 1] ? T : t)
    const bool ln_dn0 = __shfl_down_sync(FULL, (int)link0, 1) != 0;
    const bool ln_dn1 = __shfl_down_sync(FULL, (int)link1, 1) != 0;
    const bool ln_32 = __shfl_sync(FULL, (int)link1, 0) != 0;
    const bool last = lane == 31;
    const bool lnext0 = last ? ln_32 : ln_dn0;
    const bool lnext1 = !last && ln_dn1;
    int b0 = lnext0 ? T : lane;
    int b1 = lnext1 ? T : lane + 32;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o0 = __shfl_down_sync(FULL, b0, off);
      const int o1 = __shfl_down_sync(FULL, b1, off);
      if (lane + off < 32) {
        b0 = min(b0, o0);
        b1 = min(b1, o1);
      }
    }
    b0 = min(b0, __shfl_sync(FULL, b1, 0));
    const int st[2] = {start0, start1};
    const int en[2] = {b0, b1};
    const bool okc[2] = {okc0, okc1};

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!cok[s]) continue;
      const int run_len = okc[s] ? en[s] - st[s] + 1 : 0;
      const bool touches = st[s] <= first_valid || en[s] >= last_valid;
      const bool cont = run_len >= (touches ? 2 : 3) || short_chain;
      if (!cont || nob[s] >= Omax) continue;
      const int64_t k = kk[s];
      const ExpansionObs ob{cam_buf + k * Omax, obs_x + k * Omax,
                            obs_y + k * Omax, nob[s], v, cx[s], cy[s]};
      const eg3d::GNResult r = eg3d::gauss_newton(
          P_sh, ob, nob[s] + 1, (float)(nob[s] + 1), px3[s], py3[s], pz3[s],
          gn_iters, gn_eps, accept_mse, det_min);
      if (!r.valid) continue;
      px3[s] = r.x;
      py3[s] = r.y;
      pz3[s] = r.z;
      cam_buf[k * Omax + nob[s]] = v;
      obs_x[k * Omax + nob[s]] = cx[s];
      obs_y[k * Omax + nob[s]] = cy[s];
      ++nob[s];
      out_xy[(k * V + v) * 2] = cx[s];
      out_xy[(k * V + v) * 2 + 1] = cy[s];
      out_ok[k * V + v] = 1;
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!has[s]) continue;
    X[3 * kk[s]] = px3[s];
    X[3 * kk[s] + 1] = py3[s];
    X[3 * kk[s] + 2] = pz3[s];
  }
}

}  // namespace

extern "C" int eg3d_expand_chains_smem(int V, int epipolar) {
  return (V * 12 + (epipolar ? WARPS * V * 9 : 0)) * (int)sizeof(float);
}

extern "C" int eg3d_expand_chains(
    const float* grids, int V, int GH, int GW, int Kc, float cell,
    const float* P_mats, const float* F_table, const float* obs3,
    const int* cams3, const int* slot_k, const uint8_t* chain_valid, int C,
    int T, int Omax, float tol, int epipolar, float qp_cos, int gn_iters,
    float gn_eps, float accept_mse, float det_min, float* X, int* cam_buf,
    float* obs_x, float* obs_y, float* out_xy, uint8_t* out_ok,
    void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (T < 1 || T > 64 || Omax < 3) return (int)cudaErrorInvalidValue;
  const int smem = eg3d_expand_chains_smem(V, epipolar);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        expand_chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + WARPS - 1) / WARPS;
  expand_chains_kernel<<<blocks, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      grids, V, GH, GW, Kc, cell, P_mats, F_table, obs3, cams3, slot_k,
      chain_valid, C, T, Omax, tol, epipolar, qp_cos, gn_iters, gn_eps,
      accept_mse, det_min, X, cam_buf, obs_x, obs_y, out_xy, out_ok);
  return (int)cudaGetLastError();
}
