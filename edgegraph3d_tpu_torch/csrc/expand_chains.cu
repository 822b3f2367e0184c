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
// Design.  The view loop is sequential per chain (the run test couples a
// chain's points within a view, and an accepted observation moves X
// before the next view) while chains are independent, so the only lanes
// to fill are those of other chains.  Each chain gets a tile of lanes
// sized to its slot extent, one slot per lane: 8 lanes for chains of up
// to 8 slots, 16 up to 16, 32 up to 32, and 32 lanes with two slots each
// (lane l owns slots l and l + 32) up to 64.  A warp carries 4, 2, 1 or 1
// chains; stage 3's chains average 6.8 points, so most warps carry four.
// The wrapper buckets the chains by extent on the host (the caller knows
// the lengths, so no device read) and passes them in bucket order with
// the four bucket sizes.  A launch whose chains share one bucket runs a
// kernel with that tile body alone; one launch over several buckets has
// each warp take its bucket's tile width from its warp index (a
// warp-uniform branch into one of the four tile bodies).  The tiles of one warp
// share the view loop: a tuple view of one chain makes that tile's
// candidates void, not the warp's loop iteration.
//
// The run test's prefix max (run start) and suffix min (run end) are
// integer scans inside the tile (__shfl_*_sync with the tile width; for
// 64-slot chains across the two halves), and the tile's ballot gives
// first_valid, last_valid and the short-chain test: exact, no shared
// memory, no [C, T] scatter in device memory.  P [V, 3, 4] and, in
// "epipolar" mode, each chain's F_table[vs, :] rows sit in shared memory
// (48 V bytes, 624 V in "epipolar" mode), opted in above 48 KiB; above
// the card's opt-in limit (V > 372 "epipolar", V > 4,842 "closest" on an
// H100) the same body reads both from device memory through the
// read-only path (kernels.table_placement picks, before the launch).
// The candidate queries and the GN are the very device code of K1, K2
// and K3 (grid_query.cuh, gn.cuh; K2's one-thread body), so every
// decision has the same arithmetic in the same order as the plain
// version.  Grid entries load as float2 through the read-only path,
// endpoints only for non-empty slots.  The GN runs over the live observations only: slots fill in view
// order and are never freed, so a point's live observations are a prefix
// of its buffer, and the masked tail the plain version carries adds
// exact zeros.  The [K, Omax] observation buffers live in device memory;
// a lane reads only its point's live prefix.  A query is skipped where
// its result cannot matter (a tuple view, depth <= 0, no unique
// candidate).
//
// Bound on the H100: operations and latency.  Per (point, view) the K1
// query reads 9 cells x 8 entries (1.7 KB of grid, L2-resident per
// neighbourhood), and a candidate that passes the run test costs up to
// follow_gn_iters GN iterations of ~85 flops per live observation (the
// per-item costs chip_smoke.py counts).  The bytes that must move are
// small (X, obs3 and the [K, V] outputs), so the floor is the flops over
// 67 TFLOP/s.  What keeps the kernel above it is latency: each lane's
// view loop is a chain of dependent grid reads, divisions and the GN's
// serial sum over observations, and a warp waits in each view for its
// slowest lane's GN.  Registers and occupancy are in PERF.md (ptxas
// -v, printed by kernels.build(verbose=True)).
//
// One template on the compute scalar T: float, and double for
// EdgeGraphConfig(dtype="float64"), where the JAX package promotes X,
// obs3, P and F to f64 (expansion.expand_chains_compact's result_type)
// and so queries the grid with f64 projections.  The grid stays f32
// (grid_query.cuh).  The double body's tables take twice the bytes: 96 V,
// 1,248 V in "epipolar" mode (so the full scene's 49 views, 61,152 B,
// opt in above 48 KiB).

#include "gn.cuh"
#include "grid_query.cuh"

namespace {

constexpr int WARPS = 4;      // warps per block
constexpr int MAX_TILES = 4;  // chains per warp (8-lane tiles)
constexpr unsigned FULL = 0xffffffffu;

template <class T>
struct K7Args {
  const float* grids;
  int V, GH, GW, Kc;
  T cell;
  const T* P_mats;
  const T* F_table;
  const T* obs3;
  const int* cams3;
  const int* slot_k;
  const uint8_t* chain_valid;
  int T_slots, Omax;
  T tol;
  int epipolar;
  T qp_cos;
  int gn_iters;
  T gn_eps, accept_mse, det_min;
  T* X;
  int* cam_buf;
  T* obs_x;
  T* obs_y;
  T* out_xy;
  uint8_t* out_ok;
};

// The chains of one launch by tile bucket b (tiles of 8, 16, 32 lanes,
// or 32 lanes x 2 slots): order[chain_off[b] + i] for i < n[b], served by
// warps [warp_off[b], warp_off[b + 1]).
struct Buckets {
  int n[4];
  int chain_off[4];
  int warp_off[5];
};

__host__ __device__ constexpr int tile_width(int b) {
  return b == 0 ? 8 : (b == 1 ? 16 : 32);
}

// Observation o of one point during expansion: the first n from its
// [Omax] buffer row, then the candidate of the current view.
template <class T>
struct ExpansionObs {
  const int* cam;
  const T* x;
  const T* y;
  int n;
  int v_new;
  T x_new, y_new;
  __device__ __forceinline__ void operator()(int o, int* c, T* ox, T* oy,
                                             T* m) const {
    if (o < n) {
      *c = cam[o];
      *ox = x[o];
      *oy = y[o];
    } else {
      *c = v_new;
      *ox = x_new;
      *oy = y_new;
    }
    *m = T(1);
  }
};

// torch.sign: -1, 0, 1 (NaN stays NaN)
template <class T>
__device__ __forceinline__ T sgn(T d) {
  return d > T(0) ? T(1) : (d < T(0) ? T(-1) : d);
}

// Run start (st) and end (en) of the same-polyline monotone run through
// each of the lane's S slots t = tl + W s, over the tile of W lanes.
// okc = candidate ok on a valid slot; base[t] = slots t-1 and t on one
// polyline with a nonzero step; link[t] = base[t] continuing the
// previous step's direction (or starting a run); start = prefix max of
// (link ? -1 : t) clamped at 0; end = suffix min of (link[t + 1] ? T : t).
template <int W, int S, class F>
__device__ __forceinline__ void run_bounds(int tl, int T, const int* cpl,
                                           const F* cpos, const bool* okc,
                                           int* st, int* en) {
  if constexpr (S == 1) {
    const int pl_up = __shfl_up_sync(FULL, cpl[0], 1, W);
    const F pos_up = __shfl_up_sync(FULL, cpos[0], 1, W);
    const bool ok_up = __shfl_up_sync(FULL, (int)okc[0], 1, W) != 0;
    const bool first = tl == 0;
    const F d0 = cpos[0] - pos_up;
    const bool base0 = !first && cpl[0] == pl_up && okc[0] && ok_up &&
                       eg3d::vabs(d0) > F(0);
    const F sg0 = sgn(d0);
    const bool b_up = __shfl_up_sync(FULL, (int)base0, 1, W) != 0;
    const F s_up = __shfl_up_sync(FULL, sg0, 1, W);
    const bool pb0 = !first && b_up;
    const bool link0 = base0 && (!pb0 || sg0 == s_up);
    int a0 = link0 ? -1 : tl;
#pragma unroll
    for (int off = 1; off < W; off <<= 1) {
      const int o0 = __shfl_up_sync(FULL, a0, off, W);
      if (tl >= off) a0 = max(a0, o0);
    }
    st[0] = max(a0, 0);
    const bool ln_dn = __shfl_down_sync(FULL, (int)link0, 1, W) != 0;
    const bool lnext0 = tl != W - 1 && ln_dn;
    int b0 = lnext0 ? T : tl;
#pragma unroll
    for (int off = 1; off < W; off <<= 1) {
      const int o0 = __shfl_down_sync(FULL, b0, off, W);
      if (tl + off < W) b0 = min(b0, o0);
    }
    en[0] = b0;
  } else {
    // W == 32, two slots a lane: slot t - 1 is lane - 1's same slot, or
    // lane 31's first slot for t = 32
    const int lane = tl;
    const int pl_up0 = __shfl_up_sync(FULL, cpl[0], 1);
    const int pl_up1 = __shfl_up_sync(FULL, cpl[1], 1);
    const int pl_31 = __shfl_sync(FULL, cpl[0], 31);
    const F pos_up0 = __shfl_up_sync(FULL, cpos[0], 1);
    const F pos_up1 = __shfl_up_sync(FULL, cpos[1], 1);
    const F pos_31 = __shfl_sync(FULL, cpos[0], 31);
    const bool ok_up0 = __shfl_up_sync(FULL, (int)okc[0], 1) != 0;
    const bool ok_up1 = __shfl_up_sync(FULL, (int)okc[1], 1) != 0;
    const bool ok_31 = __shfl_sync(FULL, (int)okc[0], 31) != 0;
    const bool first = lane == 0;
    const int ppl1 = first ? pl_31 : pl_up1;
    const F ppos1 = first ? pos_31 : pos_up1;
    const bool pok1 = first ? ok_31 : ok_up1;
    const F d0 = cpos[0] - pos_up0;
    const F d1 = cpos[1] - ppos1;
    const bool base0 = !first && cpl[0] == pl_up0 && okc[0] && ok_up0 &&
                       eg3d::vabs(d0) > F(0);
    const bool base1 =
        cpl[1] == ppl1 && okc[1] && pok1 && eg3d::vabs(d1) > F(0);
    const F sg0 = sgn(d0), sg1 = sgn(d1);
    const bool b_up0 = __shfl_up_sync(FULL, (int)base0, 1) != 0;
    const bool b_up1 = __shfl_up_sync(FULL, (int)base1, 1) != 0;
    const bool b_31 = __shfl_sync(FULL, (int)base0, 31) != 0;
    const F s_up0 = __shfl_up_sync(FULL, sg0, 1);
    const F s_up1 = __shfl_up_sync(FULL, sg1, 1);
    const F s_31 = __shfl_sync(FULL, sg0, 31);
    const bool pb0 = !first && b_up0;
    const bool pb1 = first ? b_31 : b_up1;
    const F ps1 = first ? s_31 : s_up1;
    const bool link0 = base0 && (!pb0 || sg0 == s_up0);
    const bool link1 = base1 && (!pb1 || sg1 == ps1);
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
    st[0] = max(a0, 0);
    st[1] = max(a1, 0);
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
    en[0] = min(b0, __shfl_sync(FULL, b1, 0));
    en[1] = b1;
  }
}

// The view loop of one chain c (-1: an idle tile, which still takes part
// in the shuffles) on a tile of W lanes with S slots a lane, reading P
// [V, 12] and the chain's F rows [V, 9] from P_sh / F_sh (shared memory,
// or common.cuh Ldg tables in device memory).
template <int W, int S, class F, class Tab>
__device__ __forceinline__ void expand_tile(const K7Args<F>& a, int64_t c,
                                            int cam0, int cam1, int cam2,
                                            const Tab P_sh,
                                            const Tab F_sh) {
  const int lane = threadIdx.x & 31;
  const int tl = lane & (W - 1);
  const int T = a.T_slots, Omax = a.Omax;
  int64_t kk[S];
  bool has[S], cv[S];
  F px3[S], py3[S], pz3[S], dx0[S], dy0[S];
  int nob[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = tl + W * s;
    const bool in = c >= 0 && t < T;
    kk[s] = in ? (int64_t)a.slot_k[c * T + t] : -1;
    cv[s] = in && a.chain_valid[c * T + t] != 0;
    has[s] = kk[s] >= 0;
    px3[s] = py3[s] = pz3[s] = dx0[s] = dy0[s] = F(0);
    nob[s] = 0;
    if (has[s]) {
      const int64_t k = kk[s];
      px3[s] = a.X[3 * k];
      py3[s] = a.X[3 * k + 1];
      pz3[s] = a.X[3 * k + 2];
      dx0[s] = a.obs3[6 * k];
      dy0[s] = a.obs3[6 * k + 1];
      const int cr[3] = {cam0, cam1, cam2};
      for (int j = 0; j < 3; ++j) {
        a.cam_buf[k * Omax + j] = cr[j];
        a.obs_x[k * Omax + j] = a.obs3[6 * k + 2 * j];
        a.obs_y[k * Omax + j] = a.obs3[6 * k + 2 * j + 1];
      }
      nob[s] = 3;
    }
  }
  // chain extent from the tile's ballot: n_chain, first and last valid
  unsigned long long vm;
  if constexpr (S == 2) {
    vm = (unsigned long long)__ballot_sync(FULL, cv[0]) |
         ((unsigned long long)__ballot_sync(FULL, cv[1]) << 32);
  } else {
    constexpr unsigned tile_bits = FULL >> (32 - W);
    vm = (__ballot_sync(FULL, cv[0]) >> (lane - tl)) & tile_bits;
  }
  const bool short_chain = __popcll(vm) <= 2;
  const int first_valid = vm ? __ffsll((long long)vm) - 1 : T + 1;
  const int last_valid = vm ? 63 - __clzll((long long)vm) : -1;

  for (int v = 0; v < a.V; ++v) {
    const bool tuple_v = v == cam0 || v == cam1 || v == cam2;
    const auto Pv = P_sh + v * 12;
    int cpl[S];
    F cpos[S], cx[S], cy[S];
    bool cok[S], okc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      cpl[s] = -2;
      cpos[s] = F(0);
      cx[s] = cy[s] = F(0);
      cok[s] = false;
      if (has[s] && !tuple_v) {
        const F x = px3[s], y = py3[s], z = pz3[s];
        const F xH = Pv[0] * x + Pv[1] * y + Pv[2] * z + Pv[3];
        const F yH = Pv[4] * x + Pv[5] * y + Pv[6] * z + Pv[7];
        const F zH = Pv[8] * x + Pv[9] * y + Pv[10] * z + Pv[11];
        if (zH > F(0)) {
          const F zg = (eg3d::vabs(zH) < F(1e-12)) ? F(1e-12) : zH;
          const F qx = xH / zg;
          const F qy = yH / zg;
          eg3d::TopM<2, F> top;
          eg3d::grid_topm_one<2>(a.grids, a.GH, a.GW, a.Kc, v, qx, qy,
                                 a.cell, a.tol, top);
          if (top.ok(0) && !top.ok(1)) {
            const int pl = top.pl[0];
            int seg = top.seg[0];
            F tt = top.t[0], ex = top.x[0], ey = top.y[0];
            if (a.epipolar) {
              F l0, l1, l2;
              eg3d::epipolar(F_sh + v * 9, dx0[s], dy0[s], &l0, &l1, &l2);
              eg3d::TopM<4, F> ep;
              eg3d::epipolar_topm_one<4>(a.grids, a.GH, a.GW, a.Kc, v, qx,
                                         qy, l0, l1, l2, a.tol, a.cell, 1,
                                         a.qp_cos, ep);
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
            cpos[s] = (F)seg + tt;
            cx[s] = ex;
            cy[s] = ey;
            cok[s] = true;
          }
        }
      }
      okc[s] = cok[s] && cv[s];
    }

    // continuity: same-polyline locally monotone runs along the chain
    int st[S], en[S];
    run_bounds<W, S>(tl, T, cpl, cpos, okc, st, en);

#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!cok[s]) continue;
      const int run_len = okc[s] ? en[s] - st[s] + 1 : 0;
      const bool touches = st[s] <= first_valid || en[s] >= last_valid;
      const bool cont = run_len >= (touches ? 2 : 3) || short_chain;
      if (!cont || nob[s] >= Omax) continue;
      const int64_t k = kk[s];
      const ExpansionObs<F> ob{a.cam_buf + k * Omax, a.obs_x + k * Omax,
                               a.obs_y + k * Omax, nob[s], v, cx[s], cy[s]};
      const eg3d::GNResult<F> r = eg3d::gauss_newton(
          P_sh, ob, nob[s] + 1, (F)(nob[s] + 1), px3[s], py3[s], pz3[s],
          a.gn_iters, a.gn_eps, a.accept_mse, a.det_min);
      if (!r.valid) continue;
      px3[s] = r.x;
      py3[s] = r.y;
      pz3[s] = r.z;
      a.cam_buf[k * Omax + nob[s]] = v;
      a.obs_x[k * Omax + nob[s]] = cx[s];
      a.obs_y[k * Omax + nob[s]] = cy[s];
      ++nob[s];
      a.out_xy[(k * a.V + v) * 2] = cx[s];
      a.out_xy[(k * a.V + v) * 2 + 1] = cy[s];
      a.out_ok[k * a.V + v] = 1;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (!has[s]) continue;
    a.X[3 * kk[s]] = px3[s];
    a.X[3 * kk[s] + 1] = py3[s];
    a.X[3 * kk[s] + 2] = pz3[s];
  }
}

// The tile body of bucket b (warp-uniform) on tables P_sh / F_sh.
template <int B, class F, class Tab>
__device__ __forceinline__ void run_tile(const K7Args<F>& a, int b, int64_t c,
                                         int cam0, int cam1, int cam2,
                                         const Tab P_sh, const Tab F_sh) {
  if constexpr (B < 4) {
    if (b == B)
      expand_tile<tile_width(B), B == 3 ? 2 : 1>(a, c, cam0, cam1, cam2,
                                                 P_sh, F_sh);
  } else {
    switch (b) {  // warp-uniform
      case 0: expand_tile<8, 1>(a, c, cam0, cam1, cam2, P_sh, F_sh); break;
      case 1: expand_tile<16, 1>(a, c, cam0, cam1, cam2, P_sh, F_sh); break;
      case 2: expand_tile<32, 1>(a, c, cam0, cam1, cam2, P_sh, F_sh); break;
      case 3: expand_tile<32, 2>(a, c, cam0, cam1, cam2, P_sh, F_sh); break;
      default: break;
    }
  }
}

// B < 4: a launch whose chains all sit in bucket B (one tile body, so
// ptxas sizes registers for it alone); B == 4: any mix, each warp
// branching on its bucket.  kGlobal = false: P and each tile's F rows
// are staged in shared memory (eg3d_expand_chains_smem bytes); true:
// both are read from device memory through the read-only path.
template <int B, bool kGlobal, class F>
__global__ void expand_chains_kernel(K7Args<F> a,
                                     const int* __restrict__ order,
                                     Buckets bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  F* P_sh = reinterpret_cast<F*>(smem);  // [V, 12]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if constexpr (!kGlobal) {
    for (int i = threadIdx.x; i < a.V * 12; i += blockDim.x)
      P_sh[i] = a.P_mats[i];
  }
  // the warp's bucket (4: none), tile width and the lane's chain
  const int gw = blockIdx.x * WARPS + warp;
  int b;
  if constexpr (B < 4) {
    b = gw < bk.warp_off[4] ? B : 4;
  } else {
    b = 0;
    while (b < 4 && gw >= bk.warp_off[b + 1]) ++b;
  }
  const int W = b < 4 ? tile_width(b) : 32;
  const int tile = lane / W;
  int64_t c = -1;
  if (b < 4) {
    const int i = (gw - bk.warp_off[b]) * (32 / W) + tile;
    if (i < bk.n[b]) c = order[bk.chain_off[b] + i];
  }
  // [V, 9] F rows of this tile's chain ("epipolar" mode)
  F* F_sh = P_sh + a.V * 12 + (warp * MAX_TILES + tile) * a.V * 9;
  int cam0 = -1, cam1 = -1, cam2 = -1;
  if (c >= 0) {
    cam0 = a.cams3[3 * c];
    cam1 = a.cams3[3 * c + 1];
    cam2 = a.cams3[3 * c + 2];
    if (!kGlobal && a.epipolar) {
      const F* Fr = a.F_table + (int64_t)cam0 * a.V * 9;
      for (int i = lane - tile * W; i < a.V * 9; i += W) F_sh[i] = Fr[i];
    }
  }
  if constexpr (kGlobal) {
    const eg3d::LdgT<F> F_rows{a.F_table +
                               (int64_t)max(cam0, 0) * a.V * 9};
    run_tile<B>(a, b, c, cam0, cam1, cam2, eg3d::LdgT<F>{a.P_mats}, F_rows);
  } else {
    __syncthreads();
    run_tile<B>(a, b, c, cam0, cam1, cam2, (const F*)P_sh, (const F*)F_sh);
  }
}

template <int B, bool kGlobal, class F>
int launch(const K7Args<F>& a, const int* order, const Buckets& bk, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        expand_chains_kernel<B, kGlobal, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (bk.warp_off[4] + WARPS - 1) / WARPS;
  expand_chains_kernel<B, kGlobal, F><<<blocks, 32 * WARPS, smem, stream>>>(
      a, order, bk);
  return (int)cudaGetLastError();
}

template <int B, class F>
int launch_placed(const K7Args<F>& a, const int* order, const Buckets& bk,
                  int place, int smem, cudaStream_t stream) {
  if (place == 2) return launch<B, true>(a, order, bk, 0, stream);
  if (place == 0 && smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  return launch<B, false>(a, order, bk, smem, stream);
}

template <class F>
int smem_bytes(int V, int epipolar) {
  return (V * 12 + (epipolar ? WARPS * MAX_TILES * V * 9 : 0)) *
         (int)sizeof(F);
}

// The chunk's launch: the buckets from their sizes, then one kernel (a
// single-bucket body when only one bucket is used).
template <class F>
int expand_chains(const K7Args<F>& a, const int* order, int n8, int n16,
                  int n32, int n64, int place, cudaStream_t s) {
  if (a.T_slots < 1 || a.T_slots > 64 || a.Omax < 3 || n8 < 0 || n16 < 0 ||
      n32 < 0 || n64 < 0)
    return (int)cudaErrorInvalidValue;
  Buckets bk;
  const int n[4] = {n8, n16, n32, n64};
  int chains = 0, warps = 0;
  for (int b = 0; b < 4; ++b) {
    const int per_warp = 32 / tile_width(b);
    bk.n[b] = n[b];
    bk.chain_off[b] = chains;
    bk.warp_off[b] = warps;
    chains += n[b];
    warps += (n[b] + per_warp - 1) / per_warp;
  }
  bk.warp_off[4] = warps;
  if (warps == 0) return (int)cudaSuccess;
  const int smem = smem_bytes<F>(a.V, a.epipolar);
  const int used = (n8 > 0) + (n16 > 0) + (n32 > 0) + (n64 > 0);
  if (used > 1) return launch_placed<4>(a, order, bk, place, smem, s);
  if (n8) return launch_placed<0>(a, order, bk, place, smem, s);
  if (n16) return launch_placed<1>(a, order, bk, place, smem, s);
  if (n32) return launch_placed<2>(a, order, bk, place, smem, s);
  return launch_placed<3>(a, order, bk, place, smem, s);
}

}  // namespace

extern "C" int eg3d_expand_chains_smem(int V, int epipolar) {
  return smem_bytes<float>(V, epipolar);
}

extern "C" int eg3d_expand_chains_smem_f64(int V, int epipolar) {
  return smem_bytes<double>(V, epipolar);
}

// order [n8 + n16 + n32 + n64]: chain indices into cams3 / slot_k /
// chain_valid, bucket by bucket (extent <= 8, <= 16, <= 32, <= 64 slots).
// place: 0 P (and F rows) in at most 48 KiB of shared memory, 1 in
// opted-in shared memory, 2 in device memory (kernels.py table_placement).
extern "C" int eg3d_expand_chains(
    const float* grids, int V, int GH, int GW, int Kc, float cell,
    const float* P_mats, const float* F_table, const float* obs3,
    const int* cams3, const int* slot_k, const uint8_t* chain_valid,
    const int* order, int n8, int n16, int n32, int n64, int T, int Omax,
    float tol, int epipolar, float qp_cos, int gn_iters, float gn_eps,
    float accept_mse, float det_min, int place, float* X, int* cam_buf,
    float* obs_x, float* obs_y, float* out_xy, uint8_t* out_ok,
    void* stream) {
  const K7Args<float> a{grids, V, GH, GW, Kc, cell, P_mats, F_table, obs3,
                        cams3, slot_k, chain_valid, T, Omax, tol, epipolar,
                        qp_cos, gn_iters, gn_eps, accept_mse, det_min, X,
                        cam_buf, obs_x, obs_y, out_xy, out_ok};
  return expand_chains(a, order, n8, n16, n32, n64, place,
                       (cudaStream_t)stream);
}

// The f64 body: double P, F, obs3, X, thresholds, buffers and out_xy.
extern "C" int eg3d_expand_chains_f64(
    const float* grids, int V, int GH, int GW, int Kc, double cell,
    const double* P_mats, const double* F_table, const double* obs3,
    const int* cams3, const int* slot_k, const uint8_t* chain_valid,
    const int* order, int n8, int n16, int n32, int n64, int T, int Omax,
    double tol, int epipolar, double qp_cos, int gn_iters, double gn_eps,
    double accept_mse, double det_min, int place, double* X, int* cam_buf,
    double* obs_x, double* obs_y, double* out_xy, uint8_t* out_ok,
    void* stream) {
  const K7Args<double> a{grids, V, GH, GW, Kc, cell, P_mats, F_table, obs3,
                         cams3, slot_k, chain_valid, T, Omax, tol, epipolar,
                         qp_cos, gn_iters, gn_eps, accept_mse, det_min, X,
                         cam_buf, obs_x, obs_y, out_xy, out_ok};
  return expand_chains(a, order, n8, n16, n32, n64, place,
                       (cudaStream_t)stream);
}
