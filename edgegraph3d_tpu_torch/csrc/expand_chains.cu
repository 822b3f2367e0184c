// K7 expand_chains — the whole per-view expansion loop of a set of
// chains.
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
// to 8 slots, 16 up to 16, 32 up to 32, and 64 lanes over two warps of
// one block up to 64 (warp h's lane l owns slot 32 h + l).  The unit of
// work is a pair task, which the two warps of a block's pair take
// together: 8, 4 or 2 chains of the first three buckets (each warp runs
// its own tiles) or one 33-64-slot chain.  The wrapper sorts the chains
// longest first on the host (the caller knows the extents, so no device
// read) and launches one bucket a launch (a body with registers sized for
// that tile alone), the 64-slot bucket first and each bucket after the
// first on a stream of its own: the long chains start at once and the
// short ones fill the card beside them, where a launch per chunk of
// length-sorted chains ran the longest chains last and alone.  (One
// persistent launch over every bucket, its pairs taking tasks from a
// counter, measured slower in f64, where its mixed body needs 170
// registers; PERF.md.)
//
// The run test's prefix max (run start) and suffix min (run end) are
// integer scans inside the tile (__shfl_*_sync with the tile width), and
// the tile's ballot gives first_valid, last_valid and the short-chain
// test.  A 64-slot chain's scans cross the warp boundary through shared
// memory (`PairShared`, one 64-thread named barrier a view, bar.sync with
// the pair's id so the block's other pair runs on): warp 0 hands over
// slot 31's candidate, step and prefix max, warp 1 slot 32's candidate,
// slot 33's step and its suffix min over slots 33-63; each warp then
// finishes its scans as the single-warp two-slot tile of the earlier
// design did, with the same integer results (tests/
// test_torch_kernel_models.py holds a model of both against the plain
// run test).  Halving the lanes' serial work halves the 64-slot chains'
// view loop, which set the kernel's critical path.
//
// P [V, 3, 4] and, in "epipolar" mode, each chain's F_table[vs, :] rows
// sit in shared memory (48 V bytes, 624 V in "epipolar" mode, plus the
// pairs' exchange in the 64-slot bodies), opted in above 48 KiB; above
// the card's opt-in limit (V > 372 "epipolar", V > 4,842 "closest" on an
// H100) the same body reads both from device memory through the
// read-only path (kernels.table_placement picks, before the launch).
// The candidate queries and the GN are the very device code of K1, K2
// and K3 (grid_query.cuh, gn.cuh; K2's one-thread body), so every
// decision has the same arithmetic in the same order as the plain
// version.  Grid entries load as float2 through the read-only path,
// endpoints only for non-empty slots.  The GN runs over the live
// observations only: slots fill in view order and are never freed, so a
// point's live observations are a prefix of its buffer, and the masked
// tail the plain version carries adds exact zeros.  The [K, Omax]
// observation buffers live in device memory; a lane reads only its
// point's live prefix.  A query is skipped where its result cannot
// matter (a tuple view, depth <= 0, no unique candidate).
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

constexpr int WARPS = 4;      // warps per block: two pairs
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

// Tile width of bucket b: 8, 16, 32 lanes, or 64 over a pair of warps.
__host__ __device__ constexpr int tile_width(int b) { return 8 << b; }
// Chains of one pair task of bucket b: 8, 4, 2, or one.
__host__ __device__ constexpr int task_chains(int b) {
  return 64 / tile_width(b);
}

// What crosses the warp boundary of a 64-slot chain in one view (see
// run_bounds_pair), written by one warp and read by the other.
template <class T>
struct PairEdge {
  T pos, sg;  // warp 0: slot 31's pos, sg[31]; warp 1: slot 32's, sg[33]
  int pl;     // slot 31's / slot 32's polyline
  int scan;   // warp 0: prefix max over slots 0-31; warp 1: suffix min
              // over slots 33-63
  int bits;   // okc of that slot (1), base[31] / base[33] (2)
};

// One pair's shared memory: the edges by view parity and warp, and each
// warp's valid-slot ballot.
template <class T>
struct PairShared {
  PairEdge<T> edge[2][2];
  unsigned vm[2];
};

// Bytes of the block's two PairShared, in front of its tables (a
// multiple of 16, so the tables stay aligned).
template <class T>
__host__ __device__ constexpr int pair_bytes() {
  return (int)((2 * sizeof(PairShared<T>) + 15) / 16 * 16);
}

// The 64 threads of a block's pair p (warps 2p, 2p + 1): named barrier
// p + 1 (0 is __syncthreads'), so the other pair does not wait.
__device__ __forceinline__ void pair_sync(int pair) {
  __syncwarp();
  asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
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
// the lane's slot tl, over the tile of W lanes.  okc = candidate ok on a
// valid slot; base[t] = slots t-1 and t on one polyline with a nonzero
// step; link[t] = base[t] continuing the previous step's direction (or
// starting a run); start = prefix max of (link ? -1 : t) clamped at 0;
// end = suffix min of (link[t + 1] ? T : t).
template <int W, class F>
__device__ __forceinline__ void run_bounds(int tl, int T, int cpl, F cpos,
                                           bool okc, int* st, int* en) {
  const int pl_up = __shfl_up_sync(FULL, cpl, 1, W);
  const F pos_up = __shfl_up_sync(FULL, cpos, 1, W);
  const bool ok_up = __shfl_up_sync(FULL, (int)okc, 1, W) != 0;
  const bool first = tl == 0;
  const F d0 = cpos - pos_up;
  const bool base0 = !first && cpl == pl_up && okc && ok_up &&
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
  *st = max(a0, 0);
  const bool ln_dn = __shfl_down_sync(FULL, (int)link0, 1, W) != 0;
  const bool lnext0 = tl != W - 1 && ln_dn;
  int b0 = lnext0 ? T : tl;
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    const int o0 = __shfl_down_sync(FULL, b0, off, W);
    if (tl + off < W) b0 = min(b0, o0);
  }
  *en = b0;
}

// The same over a 64-slot chain on a pair of warps: lane l of warp h
// owns slot t = 32 h + l, and `e` is this view's PairEdge pair.  Each
// warp computes its slots' base, step sign and link from its own lanes;
// only slot 32's step (from slot 31) and the links of slots 32 and 33
// need the other warp.  Warp 0 scans its prefix max before the barrier
// and hands it over with slot 31; warp 1 scans its suffix min over slots
// 33-63 (no link there reaches back into warp 0) and hands it over with
// slot 32 and slot 33's base and sign.  After the barrier warp 0 links
// slot 31 to 32 and 32 to 33, and ends its suffix min with slot 32's
// term and warp 1's; warp 1 fixes slot 32's step and the links of slots
// 32 and 33, then scans its prefix max from warp 0's.
template <class F>
__device__ __forceinline__ void run_bounds_pair(int h, int lane, int T,
                                                int cpl, F cpos, bool okc,
                                                PairEdge<F>* e, int pair,
                                                int* st, int* en) {
  const int t = 32 * h + lane;
  const int pl_up = __shfl_up_sync(FULL, cpl, 1);
  const F pos_up = __shfl_up_sync(FULL, cpos, 1);
  const bool ok_up = __shfl_up_sync(FULL, (int)okc, 1) != 0;
  const F d = cpos - pos_up;
  bool base = lane != 0 && cpl == pl_up && okc && ok_up &&
              eg3d::vabs(d) > F(0);
  F sg = sgn(d);
  const bool b_up = __shfl_up_sync(FULL, (int)base, 1) != 0;
  const F s_up = __shfl_up_sync(FULL, sg, 1);
  bool link = base && (lane == 0 || !b_up || sg == s_up);
  if (h == 0) {
    int a = link ? -1 : t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, a, off);
      if (lane >= off) a = max(a, o);
    }
    if (lane == 31) e[0] = PairEdge<F>{cpos, sg, cpl, a, okc | base << 1};
    pair_sync(pair);
    const PairEdge<F> o = e[1];
    // at lane 31 (slot 31): the links of slots 32 and 33, and the suffix
    // min of slots 32-63
    const F d32 = o.pos - cpos;
    const bool base32 = o.pl == cpl && (o.bits & 1) && okc &&
                        eg3d::vabs(d32) > F(0);
    const F sg32 = sgn(d32);
    const bool link32 = base32 && (!base || sg32 == sg);
    const bool link33 = (o.bits & 2) && (!base32 || o.sg == sg32);
    const int tail = min(link33 ? T : 32, o.scan);
    const bool ln_dn = __shfl_down_sync(FULL, (int)link, 1) != 0;
    int b = (lane == 31 ? link32 : ln_dn) ? T : t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o2 = __shfl_down_sync(FULL, b, off);
      if (lane + off < 32) b = min(b, o2);
    }
    *st = max(a, 0);
    *en = min(b, __shfl_sync(FULL, tail, 31));
  } else {
    const bool ln_dn = __shfl_down_sync(FULL, (int)link, 1) != 0;
    int b = (lane != 31 && ln_dn) ? T : t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o2 = __shfl_down_sync(FULL, b, off);
      if (lane + off < 32) b = min(b, o2);
    }
    const F sg33 = __shfl_sync(FULL, sg, 1);
    const int base33 = __shfl_sync(FULL, (int)base, 1);
    const int scan33 = __shfl_sync(FULL, b, 1);
    if (lane == 0) e[1] = PairEdge<F>{cpos, sg33, cpl, scan33,
                                      okc | base33 << 1};
    pair_sync(pair);
    const PairEdge<F> o = e[0];
    if (lane == 0) {  // slot 32 steps from slot 31
      const F d32 = cpos - o.pos;
      base = o.pl == cpl && okc && (o.bits & 1) && eg3d::vabs(d32) > F(0);
      sg = sgn(d32);
    }
    const bool b_up2 = __shfl_up_sync(FULL, (int)base, 1) != 0;
    const F s_up2 = __shfl_up_sync(FULL, sg, 1);
    if (lane == 0) link = base && (!(o.bits & 2) || sg == o.sg);
    if (lane == 1) link = base && (!b_up2 || sg == s_up2);
    int a = link ? -1 : t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o2 = __shfl_up_sync(FULL, a, off);
      if (lane >= off) a = max(a, o2);
    }
    *st = max(max(a, o.scan), 0);
    const bool ln1 = __shfl_down_sync(FULL, (int)link, 1) != 0;
    const int b1 = __shfl_down_sync(FULL, b, 1);
    *en = lane == 0 ? min(ln1 ? T : 32, b1) : b;
  }
}

// The view loop of one chain c (-1: an idle tile, which still takes part
// in the shuffles) on a tile of W lanes (W = 64: both warps of pair
// `pair`, exchanging through px), one slot a lane, reading P [V, 12] and
// the chain's F rows [V, 9] from P_sh / F_sh (shared memory, or
// common.cuh Ldg tables in device memory).
template <int W, class F, class Tab>
__device__ __forceinline__ void expand_tile(const K7Args<F>& a, int64_t c,
                                            int cam0, int cam1, int cam2,
                                            const Tab P_sh, const Tab F_sh,
                                            PairShared<F>* px, int pair) {
  constexpr bool kPair = W == 64;
  constexpr int WL = kPair ? 32 : W;  // the tile's lanes in one warp
  const int lane = threadIdx.x & 31;
  const int h = (threadIdx.x >> 5) & 1;
  const int tl = lane & (WL - 1);
  const int t = kPair ? 32 * h + lane : tl;
  const int T = a.T_slots, Omax = a.Omax;
  const bool in = c >= 0 && t < T;
  const int64_t k = in ? (int64_t)a.slot_k[c * T + t] : -1;
  const bool cv = in && a.chain_valid[c * T + t] != 0;
  const bool has = k >= 0;
  F px3 = F(0), py3 = F(0), pz3 = F(0), dx0 = F(0), dy0 = F(0);
  int nob = 0;
  if (has) {
    px3 = a.X[3 * k];
    py3 = a.X[3 * k + 1];
    pz3 = a.X[3 * k + 2];
    dx0 = a.obs3[6 * k];
    dy0 = a.obs3[6 * k + 1];
    const int cr[3] = {cam0, cam1, cam2};
    for (int j = 0; j < 3; ++j) {
      a.cam_buf[k * Omax + j] = cr[j];
      a.obs_x[k * Omax + j] = a.obs3[6 * k + 2 * j];
      a.obs_y[k * Omax + j] = a.obs3[6 * k + 2 * j + 1];
    }
    nob = 3;
  }
  // chain extent from the tile's ballot: n_chain, first and last valid
  unsigned long long vm;
  if constexpr (kPair) {
    const unsigned mine = __ballot_sync(FULL, cv);
    if (lane == 0) px->vm[h] = mine;
    pair_sync(pair);
    vm = (unsigned long long)px->vm[0] |
         ((unsigned long long)px->vm[1] << 32);
  } else {
    constexpr unsigned tile_bits = FULL >> (32 - W);
    vm = (__ballot_sync(FULL, cv) >> (lane - tl)) & tile_bits;
  }
  const bool short_chain = __popcll(vm) <= 2;
  const int first_valid = vm ? __ffsll((long long)vm) - 1 : T + 1;
  const int last_valid = vm ? 63 - __clzll((long long)vm) : -1;

  for (int v = 0; v < a.V; ++v) {
    const bool tuple_v = v == cam0 || v == cam1 || v == cam2;
    const auto Pv = P_sh + v * 12;
    int cpl = -2;
    F cpos = F(0), cx = F(0), cy = F(0);
    bool cok = false;
    if (has && !tuple_v) {
      const F x = px3, y = py3, z = pz3;
      const F xH = Pv[0] * x + Pv[1] * y + Pv[2] * z + Pv[3];
      const F yH = Pv[4] * x + Pv[5] * y + Pv[6] * z + Pv[7];
      const F zH = Pv[8] * x + Pv[9] * y + Pv[10] * z + Pv[11];
      if (zH > F(0)) {
        const F zg = (eg3d::vabs(zH) < F(1e-12)) ? F(1e-12) : zH;
        const F qx = xH / zg;
        const F qy = yH / zg;
        eg3d::TopM<2, F> top;
        eg3d::grid_topm_one<2>(a.grids, a.GH, a.GW, a.Kc, v, qx, qy, a.cell,
                               a.tol, top);
        if (top.ok(0) && !top.ok(1)) {
          const int pl = top.pl[0];
          int seg = top.seg[0];
          F tt = top.t[0], ex = top.x[0], ey = top.y[0];
          if (a.epipolar) {
            F l0, l1, l2;
            eg3d::epipolar(F_sh + v * 9, dx0, dy0, &l0, &l1, &l2);
            eg3d::TopM<4, F> ep;
            eg3d::epipolar_topm_one<4>(a.grids, a.GH, a.GW, a.Kc, v, qx, qy,
                                       l0, l1, l2, a.tol, a.cell, 1,
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
          cpl = pl;
          cpos = (F)seg + tt;
          cx = ex;
          cy = ey;
          cok = true;
        }
      }
    }
    const bool okc = cok && cv;

    // continuity: same-polyline locally monotone runs along the chain
    int st, en;
    if constexpr (kPair)
      run_bounds_pair(h, lane, T, cpl, cpos, okc, px->edge[v & 1], pair,
                      &st, &en);
    else
      run_bounds<W>(tl, T, cpl, cpos, okc, &st, &en);

    if (!cok) continue;
    const int run_len = okc ? en - st + 1 : 0;
    const bool touches = st <= first_valid || en >= last_valid;
    const bool cont = run_len >= (touches ? 2 : 3) || short_chain;
    if (!cont || nob >= Omax) continue;
    const ExpansionObs<F> ob{a.cam_buf + k * Omax, a.obs_x + k * Omax,
                             a.obs_y + k * Omax, nob, v, cx, cy};
    const eg3d::GNResult<F> r = eg3d::gauss_newton(
        P_sh, ob, nob + 1, (F)(nob + 1), px3, py3, pz3, a.gn_iters, a.gn_eps,
        a.accept_mse, a.det_min);
    if (!r.valid) continue;
    px3 = r.x;
    py3 = r.y;
    pz3 = r.z;
    a.cam_buf[k * Omax + nob] = v;
    a.obs_x[k * Omax + nob] = cx;
    a.obs_y[k * Omax + nob] = cy;
    ++nob;
    a.out_xy[(k * a.V + v) * 2] = cx;
    a.out_xy[(k * a.V + v) * 2 + 1] = cy;
    a.out_ok[k * a.V + v] = 1;
  }
  if (has) {
    a.X[3 * k] = px3;
    a.X[3 * k + 1] = py3;
    a.X[3 * k + 2] = pz3;
  }
}

// B: the launch's tile bucket; pair task p = 2 blockIdx.x + pair takes
// chains order[i] (i < n).  kGlobal = false: P and each tile's F rows
// are staged in shared memory (eg3d_expand_chains_smem bytes, after the
// pairs' PairShared in the 64-slot body); true: both are read from
// device memory through the read-only path.
template <int B, bool kGlobal, class F>
__global__ void expand_chains_kernel(K7Args<F> a,
                                     const int* __restrict__ order, int n) {
  constexpr bool kPair = B == 3;
  constexpr int W = tile_width(B);
  extern __shared__ __align__(16) unsigned char smem[];
  PairShared<F>* pxs = reinterpret_cast<PairShared<F>*>(smem);
  F* P_sh = reinterpret_cast<F*>(smem + (kPair ? pair_bytes<F>() : 0));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = warp >> 1, h = warp & 1;
  const int tile = kPair ? 0 : lane / W;
  const int p = 2 * blockIdx.x + pair;
  const int i =
      kPair ? p : p * task_chains(B) + h * (32 / W) + tile;  // lane's chain
  const int64_t c = i < n ? (int64_t)order[i] : -1;
  if constexpr (!kGlobal) {
    for (int j = threadIdx.x; j < a.V * 12; j += blockDim.x)
      P_sh[j] = a.P_mats[j];
  }
  // [V, 9] F rows of this tile's chain ("epipolar" mode): the warp's
  // tile slots, or the pair's first warp's first slot for a 64-slot chain
  F* F_sh = P_sh + a.V * 12 +
            (kPair ? 2 * pair * MAX_TILES : warp * MAX_TILES + tile) * a.V * 9;
  int cam0 = -1, cam1 = -1, cam2 = -1;
  if (c >= 0) {
    cam0 = a.cams3[3 * c];
    cam1 = a.cams3[3 * c + 1];
    cam2 = a.cams3[3 * c + 2];
    if (!kGlobal && a.epipolar) {
      const F* Fr = a.F_table + (int64_t)cam0 * a.V * 9;
      for (int j = kPair ? 32 * h + lane : lane - tile * W; j < a.V * 9;
           j += W)
        F_sh[j] = Fr[j];
    }
  }
  PairShared<F>* px = kPair ? pxs + pair : nullptr;
  if constexpr (kGlobal) {
    if (p * task_chains(B) >= n) return;  // both warps of the pair
    const eg3d::LdgT<F> F_rows{a.F_table + (int64_t)max(cam0, 0) * a.V * 9};
    expand_tile<W>(a, c, cam0, cam1, cam2, eg3d::LdgT<F>{a.P_mats}, F_rows,
                   px, pair);
  } else {
    __syncthreads();
    if (p * task_chains(B) >= n) return;
    expand_tile<W>(a, c, cam0, cam1, cam2, (const F*)P_sh, (const F*)F_sh,
                   px, pair);
  }
}

template <int B, bool kGlobal, class F>
int launch(const K7Args<F>& a, const int* order, int n, int smem,
           cudaStream_t stream) {
  const auto kernel = expand_chains_kernel<B, kGlobal, F>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tasks = (n + task_chains(B) - 1) / task_chains(B);
  kernel<<<(tasks + 1) / 2, 32 * WARPS, smem, stream>>>(a, order, n);
  return (int)cudaGetLastError();
}

template <class F>
int table_bytes(int V, int epipolar) {
  return (V * 12 + (epipolar ? WARPS * MAX_TILES * V * 9 : 0)) *
         (int)sizeof(F);
}

template <int B, class F>
int launch_placed(const K7Args<F>& a, const int* order, int n, int place,
                  cudaStream_t stream) {
  const int pairs = B == 3 ? pair_bytes<F>() : 0;
  if (place == 2) return launch<B, true>(a, order, n, pairs, stream);
  const int smem = pairs + table_bytes<F>(a.V, a.epipolar);
  if (place == 0 && smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  return launch<B, false>(a, order, n, smem, stream);
}

// One launch: the n chains of tile bucket `bucket`.
template <class F>
int expand_chains(const K7Args<F>& a, const int* order, int bucket, int n,
                  int place, cudaStream_t s) {
  if (a.T_slots < 1 || a.T_slots > 64 || a.Omax < 3 || bucket < 0 ||
      bucket > 3 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  switch (bucket) {
    case 0: return launch_placed<0>(a, order, n, place, s);
    case 1: return launch_placed<1>(a, order, n, place, s);
    case 2: return launch_placed<2>(a, order, n, place, s);
    default: return launch_placed<3>(a, order, n, place, s);
  }
}

}  // namespace

// Shared-memory bytes of a block: the tables, plus the pairs' exchange
// when `pairs` (the 64-slot body).
extern "C" int eg3d_expand_chains_smem(int V, int epipolar, int pairs) {
  return table_bytes<float>(V, epipolar) + (pairs ? pair_bytes<float>() : 0);
}

extern "C" int eg3d_expand_chains_smem_f64(int V, int epipolar, int pairs) {
  return table_bytes<double>(V, epipolar) +
         (pairs ? pair_bytes<double>() : 0);
}

// order [n]: chain indices into cams3 / slot_k / chain_valid, all of
// tile bucket `bucket` (extent <= 8, <= 16, <= 32, <= 64 slots for 0-3).
// place: 0 P (and F rows) in at most 48 KiB of shared memory, 1 in
// opted-in shared memory, 2 in device memory (kernels.py
// table_placement).
extern "C" int eg3d_expand_chains(
    const float* grids, int V, int GH, int GW, int Kc, float cell,
    const float* P_mats, const float* F_table, const float* obs3,
    const int* cams3, const int* slot_k, const uint8_t* chain_valid,
    const int* order, int bucket, int n, int T, int Omax, float tol,
    int epipolar, float qp_cos, int gn_iters, float gn_eps, float accept_mse,
    float det_min, int place, float* X, int* cam_buf, float* obs_x,
    float* obs_y, float* out_xy, uint8_t* out_ok, void* stream) {
  const K7Args<float> a{grids, V, GH, GW, Kc, cell, P_mats, F_table, obs3,
                        cams3, slot_k, chain_valid, T, Omax, tol, epipolar,
                        qp_cos, gn_iters, gn_eps, accept_mse, det_min, X,
                        cam_buf, obs_x, obs_y, out_xy, out_ok};
  return expand_chains(a, order, bucket, n, place, (cudaStream_t)stream);
}

// The f64 body: double P, F, obs3, X, thresholds, buffers and out_xy.
extern "C" int eg3d_expand_chains_f64(
    const float* grids, int V, int GH, int GW, int Kc, double cell,
    const double* P_mats, const double* F_table, const double* obs3,
    const int* cams3, const int* slot_k, const uint8_t* chain_valid,
    const int* order, int bucket, int n, int T, int Omax, double tol,
    int epipolar, double qp_cos, int gn_iters, double gn_eps,
    double accept_mse, double det_min, int place, double* X, int* cam_buf,
    double* obs_x, double* obs_y, double* out_xy, uint8_t* out_ok,
    void* stream) {
  const K7Args<double> a{grids, V, GH, GW, Kc, cell, P_mats, F_table, obs3,
                         cams3, slot_k, chain_valid, T, Omax, tol, epipolar,
                         qp_cos, gn_iters, gn_eps, accept_mse, det_min, X,
                         cam_buf, obs_x, obs_y, out_xy, out_ok};
  return expand_chains(a, order, bucket, n, place, (cudaStream_t)stream);
}
