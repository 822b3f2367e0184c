"""Stage 3: edge reconstruction from SfM reference points.

Port of edgegraph3d_tpu/matching/refpoints.py (the reference's
per-refpoint loop, see the JAX module docstring):

  1. starting intersections within 10 px on each allowed starting view
     (kernel K1 over every (refpoint, view) pair at once);
  2. epipolar correspondences on every other view within 3x the
     starting distance (kernel K2 over every (start, view) pair);
  3. view triple (lowest view, starting view, highest view) among views
     with correspondences; DLT + GN on the candidate pairs (kernel K3);
     a seed needs exactly one valid pair;
  4. bidirectional following (matching/following.py, kernels K4 + K3)
     and post-hoc interval claiming (the host MatchesManager, or with
     claiming_backend="device" the fixpoint of matching/claiming_device.py
     at the two seed-sweep sites), with continuation rounds for chains
     that hit max_follow_steps;
  5. expansion of every chain to all views (matching/expansion.py) and
     chain extension from the expanded view sets (chain ends re-anchored
     by K1, their polylines gathered by kernel K5).

Buffers are sized from counts: the JAX fixed capacities (cap_s,
cap_rows, gn_cap) and their overflow redo paths do not exist here.
Chunk sizes only bound memory; outputs do not depend on them (all
per-item math is independent and claims run sequentially in seed
order).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu_torch.core.sfm import SfMData
from edgegraph3d_tpu_torch.devices import resolve_device
from edgegraph3d_tpu_torch.matching import following
from edgegraph3d_tpu_torch.matching import matches as matches_mod
from edgegraph3d_tpu_torch.matching.detection import (epipolar_topm_query,
                                                      grid_topm_query)
from edgegraph3d_tpu_torch.matching.grid import build_grids
from edgegraph3d_tpu_torch.ops.gather import gather_rows
from edgegraph3d_tpu_torch.ops.geometry import (all_fundamental_matrices,
                                                epipolar_line)
from edgegraph3d_tpu_torch.ops.triangulation import triangulate_gn
from edgegraph3d_tpu_torch.plgs.polyline_graph import PLGStack


@dataclass
class MatchingContext:
    """Device-resident inputs shared by all matching stages."""
    plg_coords: torch.Tensor    # [V,P,L,2] f32
    plg_length: torch.Tensor    # [V,P] i32
    grids: torch.Tensor         # [V,GH,GW,K,6] f32
    P_mats: torch.Tensor        # [V,3,4] f32
    F_table: torch.Tensor       # [V,V,3,3] f32
    cell: float
    config: EdgeGraphConfig
    device: torch.device

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"


def context_from_arrays(plg_coords, plg_length, grids, P_mats, F_table,
                        cell: float, config: EdgeGraphConfig = DEFAULT_CONFIG,
                        device="cuda") -> MatchingContext:
    """Build the port's context from host arrays (e.g. np.asarray of a
    JAX MatchingContext's fields), so both implementations can be fed
    the same grids and F table."""
    dev = resolve_device(device)
    t = lambda a, dt: torch.tensor(np.asarray(a, dt), device=dev)
    return MatchingContext(
        plg_coords=t(plg_coords, np.float32),
        plg_length=t(plg_length, np.int32), grids=t(grids, np.float32),
        P_mats=t(P_mats, np.float32), F_table=t(F_table, np.float32),
        cell=float(cell), config=config, device=dev)


#: view pairs fit at once by lmeds_fundamental_table (as in JAX)
LMEDS_PAIR_CHUNK = 256


def lmeds_fundamental_table(sfmd: SfMData, config: EdgeGraphConfig,
                            device="cuda") -> torch.Tensor:
    """All-pairs F table [V, V, 3, 3] f32 fit from common refpoint
    observations with LMedS (the reference's production path,
    cv::findFundamentalMat(FM_LMEDS) on >= fmat_min_common_points common
    points).  Pairs with too few common points get the line (0,0,1)
    sentinel: epipolar queries then find no crossings.  Pairs are fit
    LMEDS_PAIR_CHUNK at a time (the median sort is [chunk, 64, N] f32:
    ~411 MB at N = 6,268 refpoints); each pair's subsets are drawn once
    for the whole table (ops.geometry.lmeds_subsets), so the draws do not
    depend on the chunk or the device (F does, through f32 rounding
    only)."""
    from edgegraph3d_tpu_torch.ops.geometry import (fundamental_lmeds,
                                                    lmeds_subsets)

    dev = resolve_device(device)
    V = sfmd.n_cameras
    obs_xy, obs_mask = dense_observations(sfmd)
    pairs = np.asarray([(i, j) for i in range(V) for j in range(V)
                        if i != j], np.int64).reshape(-1, 2)
    F_out = torch.zeros((V, V, 3, 3), dtype=torch.float32, device=dev)
    F_out[:, :, 2, 2] = 1.0          # invalid-F sentinel: line (0,0,1)
    if len(pairs) == 0:
        return F_out
    xy = torch.as_tensor(obs_xy, device=dev)               # [N,V,2]
    mask = torch.as_tensor(obs_mask, device=dev)
    pi = torch.as_tensor(pairs, device=dev)
    mm = mask[:, pi[:, 0]] & mask[:, pi[:, 1]]             # [N,P]
    subsets = lmeds_subsets(mm.T)
    for lo in range(0, len(pairs), LMEDS_PAIR_CHUNK):
        hi = min(lo + LMEDS_PAIR_CHUNK, len(pairs))
        i, j = pi[lo:hi, 0], pi[lo:hi, 1]
        F, ok = fundamental_lmeds(
            xy[:, i].transpose(0, 1), xy[:, j].transpose(0, 1),
            mm[:, lo:hi].T, subsets=subsets[lo:hi],
            min_points=config.fmat_min_common_points)
        F_out[i[ok], j[ok]] = F[ok]
    return F_out


def build_context(sfmd: SfMData, stack: PLGStack,
                  config: EdgeGraphConfig = DEFAULT_CONFIG,
                  cell: float = 10.0, device="cuda") -> MatchingContext:
    if config.dtype != "float32":
        raise NotImplementedError("the port computes in float32 only")
    if config.fmat_source == "lmeds":
        F = lmeds_fundamental_table(sfmd, config, device).cpu()
    else:
        F = all_fundamental_matrices(sfmd.P, sfmd.center)
    grids = build_grids(stack, sfmd.widths, sfmd.heights, cell,
                        config.grid_cell_capacity)
    return context_from_arrays(stack.coords, stack.length, grids, sfmd.P,
                               F.numpy(), cell, config, device)


def dense_observations(sfmd: SfMData):
    """Ragged per-point obs -> dense [N,V] f32 arrays (obs_xy, obs_mask).

    Vectorized scatter; memoized on the scene object (all three matching
    stages ask for the same arrays)."""
    cached = getattr(sfmd, "_dense_obs_torch", None)
    if cached is not None and cached[0] == sfmd.n_points:
        return cached[1], cached[2]
    N, V = sfmd.n_points, sfmd.n_cameras
    xy = np.zeros((N, V, 2), dtype=np.float32)
    mask = np.zeros((N, V), dtype=bool)
    if N:
        counts = np.asarray([len(c) for c in sfmd.obs_cam])
        rows = np.repeat(np.arange(N), counts)
        cams = np.concatenate([np.asarray(c, np.int64).reshape(-1)
                               for c in sfmd.obs_cam])
        pts = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2)
                              for p in sfmd.obs_xy])
        xy[rows, cams] = pts
        mask[rows, cams] = True
    object.__setattr__(sfmd, "_dense_obs_torch", (N, xy, mask))
    return xy, mask


# ----------------------------------------------------------------------
# Seed formation
# ----------------------------------------------------------------------

def _start_sweep(ctx: MatchingContext, obs_xy, start_mask,
                 starting_dist: float, M: int) -> dict:
    """Starting intersections of a refpoint chunk (K1 over all (n, v)),
    compacted in (n, v, m) order.  obs_xy [N,V,2], start_mask [N,V]."""
    N, V = start_mask.shape
    view = torch.arange(V, dtype=torch.int32, device=ctx.device).repeat(N)
    c = grid_topm_query(ctx.grids, view, obs_xy.reshape(N * V, 2), ctx.cell,
                        starting_dist, M, view_cycle=True)
    s_valid = c.valid.reshape(N, V, M) & start_mask[..., None]
    idx = torch.nonzero(s_valid.reshape(-1)).flatten()
    return dict(ridx=idx // (V * M), vs=(idx // M) % V,
                pl=c.pl_id.reshape(-1)[idx], seg=c.seg.reshape(-1)[idx],
                t=c.t.reshape(-1)[idx], xy=c.xy.reshape(-1, 2)[idx],
                dist=c.dist.reshape(-1)[idx])


def _seed_from_starts(ctx: MatchingContext, starts: dict, obs_xy, obs_mask,
                      M: int) -> dict:
    """Epipolar correspondences (K2) + 3-view triangulation (K3) for the
    compacted starts; returns the valid seeds in start order:
    cams/pl_id/seg [n,3] i32, t [n,3], xy [n,3,2], X [n,3], ridx [n]."""
    cfg = ctx.config
    dev = ctx.device
    ridx, vs = starts["ridx"], starts["vs"]
    s_xy = starts["xy"]
    K = len(ridx)
    V = obs_mask.shape[1]

    # epipolar lines of each start into every view
    lines = epipolar_line(ctx.F_table[vs], s_xy[:, None, :])  # [K,V,3]
    radius = torch.clamp_max(
        starts["dist"] * cfg.detection_correspondence_factor,
        3.0 * cfg.detection_starting_dist_px)
    radius = torch.clamp_min(radius, cfg.detection_starting_dist_px
                             * cfg.detection_radius_floor_factor)

    # correspondences on every view, start-major
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat(K)
    corr = epipolar_topm_query(
        ctx.grids, view, obs_xy[ridx].reshape(K * V, 2),
        lines.reshape(K * V, 3), radius.repeat_interleave(V), ctx.cell, M)
    c_pl = corr.pl_id.reshape(K, V, M)
    c_seg = corr.seg.reshape(K, V, M)
    c_t = corr.t.reshape(K, V, M)
    c_xy = corr.xy.reshape(K, V, M, 2)
    vids = torch.arange(V, device=dev)
    corr_ok = corr.valid.reshape(K, V, M) & obs_mask[ridx][:, :, None] \
        & (vids[None, :] != vs[:, None])[:, :, None]

    # (lowest view, starting view, highest view) among views with
    # at least one correspondence
    view_has = corr_ok.any(-1)                                  # [K,V]
    v1 = torch.where(view_has, vids, V).amin(-1)
    v2 = torch.where(view_has, vids, -1).amax(-1)
    two_views = (view_has.sum(-1) >= 2) & (v1 != v2)
    v1 = torch.where(view_has.any(-1), v1, 0)
    v2 = torch.where(view_has.any(-1), v2, 0)
    arK = torch.arange(K, device=dev)
    c1_ok, c2_ok = corr_ok[arK, v1], corr_ok[arK, v2]          # [K,M]

    # triangulate the candidate pairs; a seed needs a UNIQUE valid one
    cams3 = torch.stack([vs, v1, v2], -1).to(torch.int32)      # [K,3]
    cand = c1_ok[:, :, None] & c2_ok[:, None, :] \
        & two_views[:, None, None]
    rows = torch.nonzero(cand.reshape(-1)).flatten()
    rk, i1, i2 = rows // (M * M), (rows // M) % M, rows % M
    ok = torch.zeros(K * M * M, dtype=torch.bool, device=dev)
    Xp = torch.zeros((K * M * M, 3), dtype=torch.float32, device=dev)
    if len(rows):
        pair_xy = torch.stack([s_xy[rk], c_xy[rk, v1[rk], i1],
                               c_xy[rk, v2[rk], i2]], 1)       # [R,3,2]
        Xr, _, okr = triangulate_gn(
            ctx.P_mats, cams3[rk], pair_xy,
            torch.ones((len(rows), 3), dtype=torch.bool, device=dev),
            max_iters=cfg.gn_max_iters, epsilon=cfg.gn_epsilon,
            accept_mse=cfg.match_gn_max_mse)
        ok[rows] = okr
        Xp[rows] = Xr
    ok = ok.reshape(K, M * M)
    unique = ok.sum(-1) == 1
    pick = torch.where(ok, torch.arange(M * M, device=dev), M * M) \
        .amin(-1).clamp_max(M * M - 1)
    keep = torch.nonzero(unique & two_views).flatten()
    pk = pick[keep]
    j1, j2 = pk // M, pk % M
    a1, a2 = v1[keep], v2[keep]
    s_pl, s_seg, s_t = starts["pl"], starts["seg"], starts["t"]
    return dict(
        cams=cams3[keep],
        pl_id=torch.stack([s_pl[keep], c_pl[keep, a1, j1],
                           c_pl[keep, a2, j2]], -1),
        seg=torch.stack([s_seg[keep], c_seg[keep, a1, j1],
                         c_seg[keep, a2, j2]], -1),
        t=torch.stack([s_t[keep], c_t[keep, a1, j1], c_t[keep, a2, j2]], -1),
        xy=torch.stack([s_xy[keep], c_xy[keep, a1, j1],
                        c_xy[keep, a2, j2]], 1),
        X=Xp.reshape(K, M * M, 3)[keep, pk],
        ridx=ridx[keep])


def _seed_tuple(seeds: dict) -> following.SeedTuple:
    n = len(seeds["cams"])
    valid = torch.ones(n, dtype=torch.bool, device=seeds["cams"].device)
    return following.SeedTuple(
        cams=seeds["cams"].to(torch.int32), pl_id=seeds["pl_id"].to(torch.int32),
        seg=seeds["seg"].to(torch.int32), t=seeds["t"], xy=seeds["xy"],
        X=seeds["X"], valid=valid)


def _pack_seed_outputs(out: dict) -> dict:
    """The valid seeds of dense seed fields [N, A, B, ...] (valid [N, A,
    B]), compacted in row-major (n, a, b) order, with `ridx` = n: the
    refpoint row, or the group for the stage-1/2 sweep.  Counterpart of
    the JAX _pack_seed_outputs, sized from the count."""
    valid = out["valid"]
    idx = torch.nonzero(valid.reshape(-1)).flatten()
    lead = valid.ndim
    seeds = {k: out[k].reshape((-1,) + tuple(out[k].shape[lead:]))[idx]
             for k in ("cams", "pl_id", "seg", "t", "xy", "X")}
    seeds["ridx"] = idx // max(1, int(np.prod(valid.shape[1:])))
    return seeds


def _seeds_to_host(seeds: dict, refpoint_lo: int) -> dict:
    """Device seed tensors -> the host chunk dict sweep_seeds uses, with
    `_ref` = refpoint_lo + ridx (counterpart of the JAX
    _chunk_from_seed_buf)."""
    return dict(
        cams=seeds["cams"].cpu().numpy().astype(np.int32),
        pl_id=seeds["pl_id"].cpu().numpy().astype(np.int32),
        seg=seeds["seg"].cpu().numpy().astype(np.int32),
        t=seeds["t"].cpu().numpy(), xy=seeds["xy"].cpu().numpy(),
        X=seeds["X"].cpu().numpy(),
        _ref=refpoint_lo + seeds["ridx"].cpu().numpy().astype(np.int64))


def _start_mask(obs_mask: np.ndarray, max_starting_views: int | None):
    start_mask = obs_mask.copy()
    if max_starting_views is not None:
        start_mask &= np.cumsum(obs_mask, axis=1) <= max_starting_views
    return start_mask


def compute_seeds_chunk(ctx: MatchingContext, obs_xy, obs_mask, start_mask):
    """Seeds of one refpoint chunk (device tensors), in (refpoint,
    starting view, candidate) order."""
    cfg = ctx.config
    M = cfg.max_candidates_per_view
    starts = _start_sweep(ctx, obs_xy, start_mask,
                          cfg.detection_starting_dist_px, M)
    return _seed_from_starts(ctx, starts, obs_xy, obs_mask, M)


def compute_and_follow_seeds(sfmd: SfMData, ctx: MatchingContext,
                             refpoint_chunk: int | None = None,
                             max_starting_views: int | None = None):
    """Seeding + bidirectional following, chunk by chunk over refpoints.

    Returns (round0 list of (seed_lo, chunk_dict, rows, meta),
    n_seeds_total) for sweep_seeds(precomputed=...), or (None, 0)."""
    cfg = ctx.config
    obs_xy, obs_mask = dense_observations(sfmd)
    N = len(obs_xy)
    start_mask = _start_mask(obs_mask, max_starting_views)
    if refpoint_chunk is None:
        refpoint_chunk = 1024 if ctx.on_cuda else 256
    dev = ctx.device
    round0 = []
    seed_lo = 0
    for lo in range(0, N, refpoint_chunk):
        hi = min(lo + refpoint_chunk, N)
        ox = torch.as_tensor(obs_xy[lo:hi], device=dev)
        om = torch.as_tensor(obs_mask[lo:hi], device=dev)
        sm = torch.as_tensor(start_mask[lo:hi], device=dev)
        seeds = compute_seeds_chunk(ctx, ox, om, sm)
        n_seeds = len(seeds["cams"])
        if n_seeds == 0:
            continue
        st = _seed_tuple(seeds)
        fwd, bwd, _ = following.follow_seeds_bidirectional(
            st, ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table, cfg,
            cfg.max_follow_steps)
        rows, meta = following.pack_follow_outputs(
            fwd, bwd, st.valid, cfg.new_point_min_steps)
        round0.append((seed_lo, _seeds_to_host(seeds, lo),
                       rows.cpu().numpy(), meta.cpu().numpy()))
        seed_lo += n_seeds
    return (round0 if round0 else None), seed_lo


# ----------------------------------------------------------------------
# Full stage 3: sweep, expansion, extension
# ----------------------------------------------------------------------

@dataclass
class EdgePoints:
    """Host-side reconstruction result.

    (seed_id, chain_order) identify the swept 3D chains: points of one
    seed sorted by chain_order form a 3D polyline (backward sweep,
    seed point, forward sweep)."""
    X: np.ndarray          # [M,3]
    obs_xy: np.ndarray     # [M,V,2]
    obs_mask: np.ndarray   # [M,V]
    seed_refpoint: np.ndarray  # [M] originating refpoint id
    seed_id: np.ndarray = None       # [M] global seed index
    chain_order: np.ndarray = None   # [M] order along the chain

    def __post_init__(self):
        if self.seed_id is None:
            self.seed_id = np.zeros(len(self.X), np.int64)
        if self.chain_order is None:
            self.chain_order = np.zeros(len(self.X), np.int64)

    def select(self, keep: np.ndarray) -> "EdgePoints":
        return EdgePoints(X=self.X[keep], obs_xy=self.obs_xy[keep],
                          obs_mask=self.obs_mask[keep],
                          seed_refpoint=self.seed_refpoint[keep],
                          seed_id=self.seed_id[keep],
                          chain_order=self.chain_order[keep])


def _empty_points(V: int) -> EdgePoints:
    return EdgePoints(X=np.zeros((0, 3)), obs_xy=np.zeros((0, V, 2)),
                      obs_mask=np.zeros((0, V), bool),
                      seed_refpoint=np.zeros(0, np.int64))


def _resolve_claims(ctx: MatchingContext, manager, *args,
                    skip_start_check: bool = False):
    """Dispatch a seed sweep's claiming to config.claiming_backend: the
    host-sequential MatchesManager pass, or the device fixpoint
    (matching/claiming_device.py) on ctx.device."""
    if ctx.config.claiming_backend == "device":
        from edgegraph3d_tpu_torch.matching import claiming_device
        return claiming_device.apply_device_claiming(
            manager, *args, skip_start_check=skip_start_check,
            device=ctx.device)
    return manager.resolve_and_claim(
        *args, skip_start_check=skip_start_check)


# pack_follow_outputs meta column layout (following.py)
_M_TOTAL = 0
_M_FSEG, _M_FT = slice(1, 4), slice(4, 7)
_M_BSEG, _M_BT = slice(7, 10), slice(10, 13)
_M_FNS, _M_BNS = 13, 14
_M_FXY, _M_BXY = slice(15, 21), slice(21, 27)
_M_FPERM, _M_FDIRS = slice(27, 30), slice(30, 33)
_M_BPERM, _M_BDIRS = slice(33, 36), slice(36, 39)


def sweep_seeds(seeds_np: dict | None, seed_ref: np.ndarray | None,
                ctx: MatchingContext,
                manager: "matches_mod.MatchesManager",
                seed_chunk: int | None = None, seed_id_offset: int = 0,
                max_continuation_rounds: int = 8,
                precomputed: list | None = None):
    """Follow all seeds bidirectionally, resolve collisions POST-HOC in
    seed-index order against `manager` (a seed is suppressed only by arcs
    of ACCEPTED matches), claim accepted arcs, and collect the emitted
    chain points.  Chains that hit max_follow_steps continue from their
    final position in up to `max_continuation_rounds` direction-pinned
    rounds.  With `precomputed` (from compute_and_follow_seeds) round 0's
    follows are already done.

    Returns (X, obs3, cams3, refs, seed_ids, orders) or None."""
    cfg = ctx.config
    dev = ctx.device
    S = (len(seed_ref) if precomputed is None
         else sum(len(c["_ref"]) for _, c, _, _ in precomputed))
    if seed_chunk is None:
        seed_chunk = 4096 if ctx.on_cuda else 2048
    seed_chunk = max(1, min(seed_chunk, S))

    all_X, all_obs3, all_cams3, all_ref = [], [], [], []
    all_seed, all_order = [], []

    def run_follow(chunk: dict, fixed_perm=None, fixed_dirs=None,
                   min_steps=None):
        """Follow one chunk; returns (rows, meta) numpy."""
        tens = {k: torch.as_tensor(np.ascontiguousarray(chunk[k]),
                                   device=dev)
                for k in ("cams", "pl_id", "seg", "t", "xy", "X")}
        tens["t"] = tens["t"].to(torch.float32)
        tens["xy"] = tens["xy"].to(torch.float32)
        tens["X"] = tens["X"].to(torch.float32)
        seeds = _seed_tuple(tens)
        if fixed_perm is None:
            fwd, bwd, _ = following.follow_seeds_bidirectional(
                seeds, ctx.plg_coords, ctx.plg_length, ctx.P_mats,
                ctx.F_table, cfg, cfg.max_follow_steps)
        else:
            fwd = following.follow_seeds(
                seeds, ctx.plg_coords, ctx.plg_length, ctx.P_mats,
                ctx.F_table, torch.ones((), dtype=torch.int32, device=dev),
                cfg, cfg.max_follow_steps,
                fixed_perm=torch.as_tensor(fixed_perm, device=dev),
                fixed_dirs=torch.as_tensor(fixed_dirs, device=dev))
            bwd = following.dead_follow_result(fwd, seeds)
        ms = cfg.new_point_min_steps if min_steps is None else min_steps
        rows, meta = following.pack_follow_outputs(fwd, bwd, seeds.valid, ms)
        return rows.cpu().numpy(), meta.cpu().numpy()

    def queue_continuations(pending, chunk, meta, accept, seed_gid,
                            order_base_f, order_base_b, first_round,
                            sign_map=None):
        """Collect truncated directions for the next round.  In
        continuation rounds only the fwd half runs (the call is
        direction-pinned), and the new entry inherits the parent's
        chain-order sign."""
        T = cfg.max_follow_steps
        for half, ns_col, seg_sl, t_sl, xy_sl, perm_sl, dirs_sl, base in (
            (1, _M_FNS, _M_FSEG, _M_FT, _M_FXY, _M_FPERM, _M_FDIRS,
             order_base_f),
            (-1, _M_BNS, _M_BSEG, _M_BT, _M_BXY, _M_BPERM, _M_BDIRS,
             order_base_b),
        ):
            if not first_round and half < 0:
                continue     # continuation rounds only run the fwd half
            trunc = accept & (meta[:, ns_col] >= T)
            for i in np.flatnonzero(trunc):
                sign = half if sign_map is None else int(sign_map[i])
                pending.append(dict(
                    cams=chunk["cams"][i], pl_id=chunk["pl_id"][i],
                    seg=meta[i, seg_sl].astype(np.int32),
                    t=meta[i, t_sl].astype(chunk["t"].dtype),
                    xy=meta[i, xy_sl].reshape(3, 2),
                    X=chunk["X"][i],
                    perm=meta[i, perm_sl].astype(np.int32),
                    dirs=meta[i, dirs_sl].astype(np.int32),
                    sign=sign, gid=seed_gid[i],
                    ref=chunk["_ref"][i],
                    base=base[i] + int(meta[i, ns_col])))
        manager.counters["chains_truncated"] += int(
            (accept & ((meta[:, _M_FNS] >= T)
                       | (meta[:, _M_BNS] >= T))).sum())

    def collect_rows(rows, chunk, seed_gid, accept, sign_map, base_f,
                     base_b):
        if len(rows) == 0:
            return
        sidx = rows[:, 9].astype(np.int64)
        keep = accept[sidx]
        rows = rows[keep]
        sidx = sidx[keep]
        order = rows[:, 10].astype(np.int64)
        fwd_rows = order > 0
        sign = np.where(fwd_rows, sign_map[sidx], -sign_map[sidx])
        base = np.where(fwd_rows, base_f[sidx], base_b[sidx])
        all_X.append(rows[:, 0:3].astype(np.float64))
        all_obs3.append(rows[:, 3:9].reshape(-1, 3, 2))
        all_cams3.append(chunk["cams"][sidx])
        all_ref.append(chunk["_ref"][sidx])
        all_seed.append(seed_gid[sidx])
        all_order.append(sign * (base + np.abs(order)))

    # ---- round 0: fresh seeds, bidirectional, full resolve
    pending = []
    if precomputed is None:
        round0 = []
        for lo in range(0, S, seed_chunk):
            hi = min(lo + seed_chunk, S)
            chunk = {k: v[lo:hi] for k, v in seeds_np.items()}
            chunk["_ref"] = seed_ref[lo:hi]
            rows, meta = run_follow(chunk)
            round0.append((lo, chunk, rows, meta))
    else:
        round0 = precomputed
    for lo, chunk, rows, meta in round0:
        n = len(chunk["_ref"])
        hi = lo + n
        success = meta[:, _M_TOTAL] >= cfg.new_point_min_steps
        accept = _resolve_claims(
            ctx, manager, success, chunk["cams"], chunk["pl_id"],
            chunk["seg"], chunk["t"], meta[:, _M_FSEG].astype(np.int64),
            meta[:, _M_FT], meta[:, _M_BSEG].astype(np.int64),
            meta[:, _M_BT])
        gid = np.arange(lo, hi) + seed_id_offset
        zeros = np.zeros(n, np.int64)
        ones = np.ones(n, np.int64)
        collect_rows(rows, chunk, gid, accept, ones, zeros, zeros)
        # the seed points themselves (order 0)
        ks = np.flatnonzero(accept)
        if len(ks):
            all_X.append(chunk["X"][ks])
            all_obs3.append(chunk["xy"][ks])
            all_cams3.append(chunk["cams"][ks])
            all_ref.append(chunk["_ref"][ks])
            all_seed.append(gid[ks])
            all_order.append(np.zeros(len(ks), np.int64))
        queue_continuations(pending, chunk, meta, accept, gid,
                            zeros, zeros, first_round=True)

    # ---- continuation rounds (direction pinned, start check skipped:
    # the chain's own claim covers its final position)
    rnd = 0
    while pending and rnd < max_continuation_rounds:
        rnd += 1
        manager.counters["continuation_rounds"] = max(
            manager.counters["continuation_rounds"], rnd)
        entries, pending = pending, []
        for lo in range(0, len(entries), seed_chunk):
            batch = entries[lo:lo + seed_chunk]
            n = len(batch)
            chunk = {k: np.stack([e[k] for e in batch])
                     for k in ("cams", "pl_id", "seg", "t", "xy", "X")}
            chunk["_ref"] = np.asarray([e["ref"] for e in batch])
            perm = np.stack([e["perm"] for e in batch])
            dirs = np.stack([e["dirs"] for e in batch])
            gid = np.asarray([e["gid"] for e in batch])
            sign_map = np.asarray([e["sign"] for e in batch])
            base = np.asarray([e["base"] for e in batch])
            rows, meta = run_follow(chunk, fixed_perm=perm, fixed_dirs=dirs,
                                    min_steps=1)
            success = meta[:, _M_TOTAL] >= 1
            accept = _resolve_claims(
                ctx, manager, success, chunk["cams"], chunk["pl_id"],
                chunk["seg"], chunk["t"], meta[:, _M_FSEG].astype(np.int64),
                meta[:, _M_FT], meta[:, _M_BSEG].astype(np.int64),
                meta[:, _M_BT], skip_start_check=True)
            collect_rows(rows, chunk, gid, accept, sign_map, base, base)
            queue_continuations(pending, chunk, meta, accept, gid,
                                base, base, first_round=False,
                                sign_map=sign_map)

    if not all_X:
        return None

    return (np.concatenate(all_X), np.concatenate(all_obs3),
            np.concatenate(all_cams3), np.concatenate(all_ref),
            np.concatenate(all_seed), np.concatenate(all_order))


def chain_chunks(ctx: MatchingContext, X, obs3, cams3, seed_ids, orders,
                 chain_t: int = 64, chain_chunk: int | None = None):
    """The swept chains as expand_chains_compact takes them, chunk by
    chunk: yields (rows, args, extent), `rows` the flat points of the
    chunk in slot order.  Chains are sorted by length (results are per
    chain, so the order changes no output): each chunk then holds mostly
    one of K7's tile buckets."""
    from edgegraph3d_tpu_torch.matching import expansion

    dev = ctx.device
    gather, vld = expansion.group_chains(seed_ids, orders, max_t=chain_t)
    extent = vld.sum(1)
    by_len = np.argsort(extent, kind="stable")
    gather, vld, extent = gather[by_len], vld[by_len], extent[by_len]
    X32 = np.asarray(X, np.float32)
    obs3_32 = np.asarray(obs3, np.float32)
    if chain_chunk is None:
        chain_chunk = 8192 if ctx.on_cuda else 256
    for lo in range(0, len(gather), chain_chunk):
        hi = min(lo + chain_chunk, len(gather))
        gi = gather[lo:hi]
        vl = vld[lo:hi]
        kidx = np.flatnonzero(vl.reshape(-1))
        rows = gi.reshape(-1)[kidx]
        yield rows, (
            ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            torch.as_tensor(X32[rows], device=dev),
            torch.as_tensor(obs3_32[rows], device=dev),
            torch.as_tensor(cams3[gi[:, 0]].astype(np.int32), device=dev),
            torch.as_tensor((kidx // chain_t).astype(np.int64), device=dev),
            torch.as_tensor((kidx % chain_t).astype(np.int64), device=dev),
            torch.ones(len(kidx), dtype=torch.bool, device=dev),
            torch.as_tensor(vl, device=dev), ctx.config, hi - lo,
            chain_t), extent[lo:hi]


def expand_and_assemble(ctx: MatchingContext, X, obs3, cams3, refs,
                        seed_ids, orders, chain_t: int = 64,
                        chain_chunk: int | None = None) -> EdgePoints:
    """Chain-aware expansion of every swept chain to all other views
    with GN re-validation (matching/expansion.py), then EdgePoints
    assembly.  Point coordinates take the per-view re-refined values."""
    from edgegraph3d_tpu_torch.matching import expansion

    V = ctx.P_mats.shape[0]
    Np = len(X)
    if Np == 0:
        return _empty_points(V)
    obs_xy = np.zeros((Np, V, 2), dtype=np.float32)
    obs_mask = np.zeros((Np, V), dtype=bool)
    X_out = np.asarray(X, np.float64).copy()
    for rows, args, extent in chain_chunks(ctx, X, obs3, cams3, seed_ids,
                                           orders, chain_t, chain_chunk):
        Xr, oxy, ook = expansion.expand_chains_compact(*args, extent=extent)
        X_out[rows] = Xr.cpu().numpy()
        obs_xy[rows] = oxy.cpu().numpy()
        obs_mask[rows] = ook.cpu().numpy()
    return EdgePoints(X=X_out, obs_xy=obs_xy, obs_mask=obs_mask,
                      seed_refpoint=refs, seed_id=seed_ids,
                      chain_order=orders)


# ----------------------------------------------------------------------
# Chain extension from the expanded view set
# ----------------------------------------------------------------------

def _locate_on_polylines(ctx: MatchingContext, xy_ev, dir_ev,
                         reanchor_tol: float):
    """Per (end, view): closest polyline position within reanchor_tol
    (K1, M=1) plus the REMAINING arc length of that polyline in the
    image-space direction dir_ev.  xy_ev/dir_ev [E,V,2] -> [E,V,6] rows
    [pl, seg, t, ok, dist, remaining]."""
    E, V = xy_ev.shape[:2]
    L = ctx.plg_coords.shape[2]
    dev = ctx.device
    f = xy_ev.dtype
    view = torch.arange(V, dtype=torch.int32, device=dev).repeat(E)
    cand = grid_topm_query(ctx.grids, view, xy_ev.reshape(E * V, 2),
                           ctx.cell, reanchor_tol, 1, view_cycle=True)
    pl = torch.clamp_min(cand.pl_id[:, 0], 0).long()
    seg = torch.clamp_min(cand.seg[:, 0], 0).long()
    vl = view.long()
    P = ctx.plg_coords.shape[1]
    poly = gather_rows(ctx.plg_coords.reshape(-1, 2 * L),
                       vl * P + pl).reshape(-1, L, 2)           # [Q,L,2]
    n_pts = ctx.plg_length[vl, pl]
    dx = poly[:, 1:, 0] - poly[:, :-1, 0]
    dy = poly[:, 1:, 1] - poly[:, :-1, 1]
    seg_len = torch.sqrt(dx * dx + dy * dy)
    seg_ok = torch.arange(L - 1, device=dev)[None, :] < (n_pts[:, None] - 1)
    seg_len = torch.where(seg_ok, seg_len, 0.0)
    take = lambda a: a.gather(1, seg[:, None])[:, 0]
    d = dir_ev.reshape(E * V, 2)
    fwd = take(dx) * d[:, 0] + take(dy) * d[:, 1] >= 0
    cum = torch.cumsum(seg_len, dim=1)
    total = cum[:, -1]
    done = take(cum) - (1.0 - cand.t[:, 0]) * take(seg_len)
    remaining = torch.where(fwd, total - done, done)
    out = torch.stack([
        cand.pl_id[:, 0].to(f), cand.seg[:, 0].to(f), cand.t[:, 0],
        cand.valid[:, 0].to(f), torch.clamp_max(cand.dist[:, 0], 1e18),
        remaining], dim=1)
    return out.reshape(E, V, 6)


def _project_pos(P_mats, X):
    """[E,3] through every camera [V,3,4] -> [E,V,2], depth floored at
    1e-9 (the extension gate's own projection)."""
    x, y, z = X[:, None, 0], X[:, None, 1], X[:, None, 2]
    r = [P_mats[None, :, i, 0] * x + P_mats[None, :, i, 1] * y
         + P_mats[None, :, i, 2] * z + P_mats[None, :, i, 3]
         for i in range(3)]
    w = torch.clamp_min(r[2], 1e-9)
    return torch.stack([r[0] / w, r[1] / w], dim=-1)


def _extension_locate_follow(ctx: MatchingContext, X_end, X_prev,
                             end_obs_xy, m, cfg: EdgeGraphConfig):
    """Per chain end: reprojection-consistency gating, polyline
    re-anchoring, remaining-arc view ranking, bidirectional follow and
    packing.  X_end/X_prev [E,3], end_obs_xy [E,V,2], m [E,V].
    Returns (rows, meta, tv [E,3], loc_sel [E,3,6]) on the device."""
    E = m.shape[0]
    away = X_end - X_prev
    proj = _project_pos(ctx.P_mats, X_end)
    dd = proj - end_obs_xy
    resid = torch.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
    dir2 = _project_pos(ctx.P_mats, X_end + 0.5 * away) - proj
    loc = _locate_on_polylines(ctx, end_obs_xy, dir2,
                               cfg.extension_reanchor_px)   # [E,V,6]
    eligible = m & (loc[..., 3] > 0.5) \
        & (resid < cfg.extension_consistency_px)
    remaining = torch.where(eligible, loc[..., 5], -1.0)
    rank = torch.sort(-remaining, dim=1, stable=True).indices
    tv = torch.sort(rank[:, :3], dim=1).values                  # [E,3]
    ok_e = eligible.sum(1) >= 3
    loc_sel = torch.take_along_dim(loc, tv[:, :, None].expand(E, 3, 6), 1)
    end_xy = torch.take_along_dim(end_obs_xy, tv[:, :, None].expand(E, 3, 2),
                                  1)
    seeds = following.SeedTuple(
        cams=tv.to(torch.int32), pl_id=loc_sel[..., 0].to(torch.int32),
        seg=loc_sel[..., 1].to(torch.int32), t=loc_sel[..., 2].contiguous(),
        xy=end_xy.contiguous(), X=X_end, valid=ok_e)
    fwd, bwd, _ = following.follow_seeds_bidirectional(
        seeds, ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table, cfg,
        cfg.max_follow_steps)
    rows, meta = following.pack_follow_outputs(fwd, bwd, seeds.valid, 1)
    return rows, meta, tv, loc_sel


def extend_chains(ctx: MatchingContext, pts: EdgePoints,
                  manager: "matches_mod.MatchesManager",
                  stats=None) -> EdgePoints:
    """Grow chains outward from their ends using the EXPANDED view set
    (see the JAX module: every chain end whose expanded observation set
    still has >= 3 consistent views seeds a fresh bidirectional follow;
    only the direction moving away from the chain is kept; new points are
    expanded and appended with continuing chain orders)."""
    for _ in range(ctx.config.max_extension_rounds):
        added = _extend_once(ctx, pts, manager, stats=stats)
        if added is None:
            break
        pts = added
    return pts


def _extend_once(ctx: MatchingContext, pts: EdgePoints, manager,
                 stats=None, end_chunk: int | None = None):
    import time as _time

    def _log(name, t0, count=None):
        if stats is not None:
            stats.timings[name] = stats.timings.get(name, 0.0) \
                + (_time.time() - t0)
            if count is not None:
                stats.counts[name] = stats.counts.get(name, 0) + count

    cfg = ctx.config
    dev = ctx.device
    n = len(pts.X)
    if n == 0:
        return None
    order = np.lexsort((pts.chain_order, pts.seed_id))
    sid = pts.seed_id[order]
    bounds = np.concatenate(
        [[0], np.flatnonzero(np.diff(sid)) + 1, [n]])
    ends = []                                   # (end_row, prev_row, sign)
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a < 2:
            continue
        ends.append((order[b - 1], order[b - 2], 1))
        ends.append((order[a], order[a + 1], -1))
    if not ends:
        return None
    e = np.asarray(ends, np.int64)
    E = len(e)
    _t0 = _time.time()

    m = pts.obs_mask[e[:, 0]] & pts.obs_mask[e[:, 1]]       # [E,V]
    X_end = pts.X[e[:, 0]]
    X_prev = pts.X[e[:, 1]]
    away_dir = X_end - X_prev                                # [E,3]
    end_xy = pts.obs_xy[e[:, 0]]

    if end_chunk is None:
        end_chunk = 16384 if ctx.on_cuda else 4096
    rows_l, meta_l, tv_l, loc_l = [], [], [], []
    for lo in range(0, E, end_chunk):
        hi = min(lo + end_chunk, E)
        f32 = lambda a: torch.as_tensor(a[lo:hi].astype(np.float32),
                                        device=dev)
        rows_d, meta_d, tv_d, loc_d = _extension_locate_follow(
            ctx, f32(X_end), f32(X_prev), f32(end_xy),
            torch.as_tensor(m[lo:hi], device=dev), cfg)
        rows_c = rows_d.cpu().numpy()
        if len(rows_c):
            rows_c[:, 9] += lo            # seed idx -> global end idx
            rows_l.append(rows_c)
        meta_l.append(meta_d.cpu().numpy())
        tv_l.append(tv_d.cpu().numpy())
        loc_l.append(loc_d.cpu().numpy())
    meta = np.concatenate(meta_l)
    tv = np.concatenate(tv_l).astype(np.int32)
    loc = np.concatenate(loc_l)
    _log("ext_locate_follow", _t0, E)
    _t0 = _time.time()
    if not rows_l:
        return None
    rows = np.concatenate(rows_l)

    # away-from-chain direction filter: the first new 3D point of the
    # kept direction must lie on the far side of the end point
    sidx = rows[:, 9].astype(np.int64)
    rord = rows[:, 10].astype(np.int64)
    dots = np.full((E, 2), -np.inf)                          # [E, fwd/bwd]
    first = np.abs(rord) == 1
    for drow in np.flatnonzero(first):
        s = sidx[drow]
        d = 0 if rord[drow] > 0 else 1
        dots[s, d] = np.dot(rows[drow, 0:3] - X_end[s], away_dir[s])
    keep_dir = dots > 0
    # at most ONE direction continues a chain end; keep the one reaching
    # farther out
    bidx = np.flatnonzero(keep_dir.all(axis=1))
    keep_dir[bidx, np.argmin(dots[bidx], axis=1)] = False
    keep_rows = np.where(rord > 0, keep_dir[sidx, 0], keep_dir[sidx, 1])
    if not keep_rows.any():
        return None

    # claim the kept arcs (zero-span finals for the dropped direction);
    # skip_start_check=True as in the reference's add-view walks
    success = keep_dir.any(axis=1)
    f_seg = np.where(keep_dir[:, 0:1], meta[:, _M_FSEG].astype(np.int64),
                     loc[..., 1].astype(np.int64))
    f_t = np.where(keep_dir[:, 0:1], meta[:, _M_FT], loc[..., 2])
    b_seg = np.where(keep_dir[:, 1:2], meta[:, _M_BSEG].astype(np.int64),
                     loc[..., 1].astype(np.int64))
    b_t = np.where(keep_dir[:, 1:2], meta[:, _M_BT], loc[..., 2])
    accept = manager.resolve_and_claim(
        success, tv, loc[..., 0].astype(np.int64),
        loc[..., 1].astype(np.int64), loc[..., 2],
        f_seg, f_t, b_seg, b_t, skip_start_check=True)
    keep_rows &= accept[sidx]
    if not keep_rows.any():
        return None
    rows = rows[keep_rows]
    sidx = sidx[keep_rows]
    rord = rord[keep_rows]

    _log("ext_claims", _t0)
    _t0 = _time.time()
    # expand the new points to all views (fresh short chains per end)
    sign_e = e[:, 2]
    parent_order = pts.chain_order[e[:, 0]]
    new_pts = expand_and_assemble(
        ctx, rows[:, 0:3].astype(np.float64),
        rows[:, 3:9].reshape(-1, 3, 2), tv[sidx],
        pts.seed_refpoint[e[sidx, 0]], sidx, np.abs(rord))
    # graft onto the parent chains: parent seed ids, continuing orders
    # (both computed before assigning: new_pts.seed_id aliases sidx)
    parent_sid = pts.seed_id[e[sidx, 0]]
    new_order = parent_order[sidx] + sign_e[sidx] * np.abs(rord)
    new_pts.seed_id[:] = parent_sid
    new_pts.chain_order[:] = new_order
    _log("ext_expand", _t0, len(new_pts.X))
    manager.counters["extension_points"] = \
        manager.counters.get("extension_points", 0) + len(new_pts.X)
    manager.counters["extension_rounds"] = \
        manager.counters.get("extension_rounds", 0) + 1

    return EdgePoints(
        X=np.concatenate([pts.X, new_pts.X]),
        obs_xy=np.concatenate([pts.obs_xy, new_pts.obs_xy]),
        obs_mask=np.concatenate([pts.obs_mask, new_pts.obs_mask]),
        seed_refpoint=np.concatenate([pts.seed_refpoint,
                                      new_pts.seed_refpoint]),
        seed_id=np.concatenate([pts.seed_id, new_pts.seed_id]),
        chain_order=np.concatenate([pts.chain_order,
                                    new_pts.chain_order]))


def reconstruct_from_refpoints(
    sfmd: SfMData, ctx: MatchingContext,
    refpoint_chunk: int | None = None, seed_chunk: int | None = None,
    max_starting_views: int | None = None,
    manager: "matches_mod.MatchesManager | None" = None,
    seed_id_offset: int = 0,
) -> EdgePoints:
    """Run stage 3 over all refpoints (seed, follow, claim, expand,
    extend)."""
    V = ctx.P_mats.shape[0]
    if manager is None:
        manager = matches_mod.MatchesManager(ctx.plg_length.cpu().numpy())
    round0, _ = compute_and_follow_seeds(sfmd, ctx, refpoint_chunk,
                                         max_starting_views)
    if round0 is None:
        return _empty_points(V)
    res = sweep_seeds(None, None, ctx, manager, seed_chunk, seed_id_offset,
                      precomputed=round0)
    if res is None:
        return _empty_points(V)
    pts = expand_and_assemble(ctx, *res)
    return extend_chains(ctx, pts, manager)
