"""Chain-aware all-view expansion with Gauss-Newton re-validation.

Port of edgegraph3d_tpu/matching/expansion.py (expand_chains_compact and
group_chains; see the JAX module for the reference semantics).  Views
are visited in order; for each view every chain point is projected, a
candidate that is unique within 4 px is looked up (K1's query, plus K2's
in "epipolar" mode), same-polyline monotone runs along the chain are
kept (>= 3 points, >= 2 at a chain end), and each surviving observation
is re-validated by a warm-started GN over all the point's observations
(K3's GN).  An accepted observation updates the point before the next
view.

On the card the whole view loop is kernel K7 `expand_chains`
(csrc/expand_chains.cu): each chain gets a tile of 8, 16 or 32 lanes, or
64 over two warps, by its slot extent, and the wrapper hands the chains
over longest first, bucketed by that extent, which callers know on the
host (`launch_plan`): one launch per bucket, the longest bucket first,
each after the first on a stream of its own, so that the long chains
run beside the short ones.  The plain version
`_expand_chains_compact_plain` is the same loop in torch around the K1 /
K2 / K3 wrappers; `expand_chains_compact` takes it for CPU tensors
only.  The dense twin expand_chains_sweep is not ported (ROADMAP queue
A item 11).

Both run in the promoted type of X, obs3, P and F, as the JAX function's
result_type: f32, or f64 under EdgeGraphConfig(dtype="float64") (the
caller's f32 X and obs3 widened to the f64 cameras' type), where K7
launches its f64 body.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.matching.detection import (epipolar_topm_query,
                                                      grid_topm_query)
from edgegraph3d_tpu_torch.ops.geometry import epipolar_line, project_depth
from edgegraph3d_tpu_torch.ops.triangulation import triangulate_gn


def _expand_candidates(grids, v: int, proj, line, cell: float, tol: float,
                       mode: str, qp_cos: float = 0.965):
    """Per-query expansion candidate on view v: the closest polyline
    within tol, valid only when it is the UNIQUE polyline within tol.
    In "epipolar" mode the position moves to the crossing of the
    driving-view epipolar line with that polyline when one exists.
    Returns (pl, seg, t, xy, ok)."""
    Q = proj.shape[0]
    view = torch.full((Q,), v, dtype=torch.int32, device=proj.device)
    cl = grid_topm_query(grids, view, proj, cell, tol, 2)
    pl, seg, t, xy = cl.pl_id[:, 0], cl.seg[:, 0], cl.t[:, 0], cl.xy[:, 0]
    ok = cl.valid[:, 0] & ~cl.valid[:, 1]
    if mode == "epipolar":
        rad = torch.full((Q,), tol, dtype=proj.dtype, device=proj.device)
        ep = epipolar_topm_query(grids, view, proj, line, rad, cell, 4,
                                 exclude_parallel_cos=qp_cos)
        same = ep.valid & (ep.pl_id == pl[:, None])
        has = same.any(1)
        j = torch.where(same, torch.arange(4, device=proj.device), 4) \
            .amin(1).clamp_max(3)
        rq = torch.arange(Q, device=proj.device)
        seg = torch.where(has, ep.seg[rq, j], seg)
        t = torch.where(has, ep.t[rq, j], t)
        xy = torch.where(has[:, None], ep.xy[rq, j], xy)
    return pl, seg, t, xy, ok


def _monotone_runs(pl_id, pos, cand_ok, chain_valid):
    """Per chain point [C, T]: length of the same-polyline locally
    monotone run it belongs to, and whether the run touches a chain end
    (prefix max / suffix min scans over T)."""
    C, T = pl_id.shape
    dev = pl_id.device
    idx = torch.arange(T, device=dev)
    ok = cand_ok & chain_valid
    same_pl = (pl_id[:, 1:] == pl_id[:, :-1]) & ok[:, 1:] & ok[:, :-1]
    dpos = pos[:, 1:] - pos[:, :-1]
    base = same_pl & (dpos.abs() > 0)
    sign = torch.sign(dpos)
    col_f = torch.zeros((C, 1), dtype=torch.bool, device=dev)
    prev_base = torch.cat([col_f, base[:, :-1]], 1)
    sign_agree = torch.cat([~col_f, sign[:, 1:] == sign[:, :-1]], 1)
    link = torch.cat([col_f, base & (~prev_base | sign_agree)], 1)
    start = torch.cummax(torch.where(link, -1, idx), dim=1).values
    start = torch.clamp_min(start, 0)
    link_next = torch.cat([link[:, 1:], col_f], 1)
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(link_next, T, idx), [1]), dim=1).values, [1])
    run_len = torch.where(ok, end - start + 1, 0)
    first_valid = torch.where(chain_valid, idx, T + 1).amin(1)
    last_valid = torch.where(chain_valid, idx, -1).amax(1)
    touches = (start <= first_valid[:, None]) | (end >= last_valid[:, None])
    return run_len, touches


def _initial_outputs(obs3, cam_rows, item_ok, V: int):
    """out_xy [K,V,2] and out_ok [K,V] holding each point's three tuple
    observations (out_ok only where item_ok)."""
    K = obs3.shape[0]
    r = torch.arange(K, device=obs3.device)
    out_xy = torch.zeros((K, V, 2), dtype=obs3.dtype, device=obs3.device)
    out_ok = torch.zeros((K, V), dtype=torch.bool, device=obs3.device)
    for k in range(3):
        ck = cam_rows[:, k].long()
        out_xy[r, ck] = obs3[:, k]
        out_ok[r, ck] = item_ok
    return out_xy, out_ok


def _expand_chains_compact_plain(plg_coords, grids, P_mats, F_table,
                                 cell: float, X, obs3, cams3, chain_idx,
                                 t_idx, item_ok, chain_valid,
                                 cfg: EdgeGraphConfig, C: int, T: int,
                                 extent=None):
    """Plain version of K7: the view loop in torch around the K1 / K2 /
    K3 wrappers, one host sync per view.  It needs no tile buckets and
    ignores `extent`, which it accepts so that it can stand in for the
    wrapper (profile_run.py --expansion plain swaps it in)."""
    V = P_mats.shape[0]
    K = X.shape[0]
    dev = X.device
    f = kernels.compute_dtype(X, obs3, P_mats, F_table)
    X, obs3, P_mats, F_table = (a.to(f) for a in (X, obs3, P_mats, F_table))
    X = X.clone()
    tol = float(math.sqrt(cfg.expand_max_projection_distsq))
    Omax = min(V, max(cfg.max_obs_per_point, 4))
    ci = chain_idx.long()
    ti = t_idx.long()
    ci_ok, ti_ok = ci[item_ok], ti[item_ok]
    cam_rows = cams3[ci]                                  # [K,3]
    vs = cam_rows[:, 0].long()

    cam_buf = torch.zeros((K, Omax), dtype=torch.int32, device=dev)
    cam_buf[:, :3] = cam_rows
    obs_x = torch.zeros((K, Omax), dtype=f, device=dev)
    obs_y = torch.zeros((K, Omax), dtype=f, device=dev)
    obs_x[:, :3] = obs3[..., 0]
    obs_y[:, :3] = obs3[..., 1]
    obs_mask = torch.zeros((K, Omax), dtype=torch.bool, device=dev)
    obs_mask[:, :3] = item_ok[:, None]
    out_xy, out_ok = _initial_outputs(obs3, cam_rows, item_ok, V)
    n_chain = chain_valid.sum(1)
    epipolar = cfg.expand_correspondence_mode == "epipolar"

    for v in range(V):
        proj, depth = project_depth(P_mats[v], X)
        line = epipolar_line(F_table[vs, v], obs3[:, 0]) if epipolar \
            else None
        c_pl, c_seg, c_t, c_xy, uq = _expand_candidates(
            grids, v, proj, line, cell, tol, cfg.expand_correspondence_mode,
            cfg.quasiparallel_cos)
        is_tuple = (cam_rows == v).any(1)
        c_ok = uq & (depth > 0) & ~is_tuple & item_ok

        # continuity: same-polyline locally monotone runs along the chain
        pos = c_seg.to(f) + c_t
        pl_g = torch.full((C, T), -2, dtype=torch.int32, device=dev)
        pos_g = torch.zeros((C, T), dtype=f, device=dev)
        ok_g = torch.zeros((C, T), dtype=torch.bool, device=dev)
        pl_g[ci_ok, ti_ok] = c_pl[item_ok]
        pos_g[ci_ok, ti_ok] = pos[item_ok]
        ok_g[ci_ok, ti_ok] = c_ok[item_ok]
        run_len, touches = _monotone_runs(pl_g, pos_g, ok_g, chain_valid)
        min_run = torch.where(touches, 2, 3)
        cont_g = (run_len >= min_run) | (n_chain[:, None] <= 2)
        c_ok = c_ok & cont_g[ci, ti]

        # GN re-validation with this view's observation in the first
        # free slot, warm-started from the current point
        free = ~obs_mask
        put = c_ok & free.any(1)
        rows = torch.nonzero(put).flatten()
        if len(rows) == 0:
            continue
        slot = torch.argmax(free[rows].to(torch.uint8), dim=1)
        rr = torch.arange(len(rows), device=dev)
        cam_try = cam_buf[rows]
        x_try = obs_x[rows]
        y_try = obs_y[rows]
        m_try = obs_mask[rows]
        cam_try[rr, slot] = v
        x_try[rr, slot] = c_xy[rows, 0]
        y_try[rr, slot] = c_xy[rows, 1]
        m_try[rr, slot] = True
        Xr, _, ok = triangulate_gn(
            P_mats, cam_try, torch.stack([x_try, y_try], -1), m_try,
            X0=X[rows], max_iters=cfg.follow_gn_iters,
            epsilon=cfg.gn_epsilon, accept_mse=cfg.match_gn_max_mse)
        acc = rows[ok]
        X[acc] = Xr[ok]
        cam_buf[acc] = cam_try[ok]
        obs_x[acc] = x_try[ok]
        obs_y[acc] = y_try[ok]
        obs_mask[acc] = m_try[ok]
        out_xy[acc, v] = c_xy[acc]
        out_ok[acc, v] = True
    return X, out_xy, out_ok


def _chain_slots(chain_idx, t_idx, item_ok, C: int, T: int):
    """[C, T] int32: the point at each chain slot, -1 where none.  Rows
    with item_ok False are left out (scattered to a dropped extra slot),
    so no host sync is needed."""
    dev = chain_idx.device
    flat = torch.where(item_ok, chain_idx.long() * T + t_idx.long(), C * T)
    slots = torch.full((C * T + 1,), -1, dtype=torch.int32, device=dev)
    slots[flat] = torch.arange(len(flat), dtype=torch.int32, device=dev)
    return slots[:C * T].view(C, T)


#: K7's tile buckets: a chain of at most TILE_SLOTS[b] slots takes a tile
#: of 8, 16 or 32 lanes, or 64 over a pair of warps, one slot a lane
TILE_SLOTS = (8, 16, 32, 64)
#: chains of one pair task (the work a pair of warps takes) by bucket
TASK_CHAINS = (8, 4, 2, 1)
#: bytes of a block's pair exchange (csrc/expand_chains.cu pair_bytes),
#: by element size, in the 64-slot body's launches
PAIR_BYTES = {4: 176, 8: 272}


class K7Launch(NamedTuple):
    """One K7 launch: its tile bucket, the offset of its first chain in
    the plan's order, its chain count and its pair tasks (its grid is
    half as many blocks)."""
    bucket: int
    first: int
    n: int
    tasks: int


class K7Plan(NamedTuple):
    order: np.ndarray      # [C] int32: the chains, longest first
    launches: list         # [K7Launch], in launch order


def launch_plan(extent: np.ndarray) -> K7Plan:
    """K7's launches for chains of the given slot extents (1 + a chain's
    last slot holding a point or marked valid; 0 for none): the chains
    longest first (stable), so bucket by bucket from the 64-slot one
    down, and one launch per non-empty tile bucket in that order (the
    wrapper runs each after the first on a stream of its own)."""
    extent = np.asarray(extent)
    b = np.searchsorted(TILE_SLOTS, extent)
    if len(b) and b.max() >= len(TILE_SLOTS):
        raise ValueError("expand_chains: a chain extent above 64 slots")
    counts = np.bincount(b, minlength=len(TILE_SLOTS))
    launches, first = [], 0
    for bucket in (3, 2, 1, 0):
        n = int(counts[bucket])
        if n:
            launches.append(K7Launch(bucket, first, n,
                                     -(-n // TASK_CHAINS[bucket])))
        first += n
    return K7Plan(np.argsort(-extent, kind="stable").astype(np.int32),
                  launches)


def k7_table_bytes(V: int, epipolar: bool, dtype=torch.float32,
                   pairs: bool = False) -> int:
    """Bytes of K7's per-block table: P [V, 3, 4] and, in "epipolar"
    mode, the F rows [V, 3, 3] of each of a block's 16 tiles, 4 bytes an
    entry in f32 and 8 in f64, plus with `pairs` (a launch that runs
    64-slot tiles) the pairs' exchange (csrc expand_chains.cu
    eg3d_expand_chains_smem)."""
    size = 8 if dtype == torch.float64 else 4
    return (V * 12 + (16 * V * 9 if epipolar else 0)) * size \
        + (PAIR_BYTES[size] if pairs else 0)


_STREAMS: dict = {}


def _side_streams(device) -> list:
    """Three streams of `device` for a call's second to fourth launch
    (cached: K7 runs a few times a scene)."""
    index = device.index if device.index is not None else 0
    if index not in _STREAMS:
        _STREAMS[index] = [torch.cuda.Stream(device) for _ in range(3)]
    return _STREAMS[index]


def expand_chains_compact(plg_coords, grids, P_mats, F_table, cell: float,
                          X, obs3, cams3, chain_idx, t_idx, item_ok,
                          chain_valid, cfg: EdgeGraphConfig, C: int, T: int,
                          extent: np.ndarray):
    """Expand K chain points (flat, each at slot (chain_idx, t_idx) of a
    [C, T] chain layout, one point per slot) to all views.

    X [K,3], obs3 [K,3,2] tuple-view observations, cams3 [C,3] i32,
    chain_idx / t_idx [K] (in range), item_ok [K], chain_valid [C,T].
    `extent` [C] (host) is each chain's slot extent (see launch_plan),
    which the caller knows without reading the device.  Returns (X' [K,3],
    out_xy [K,V,2], out_ok [K,V]), X' and out_xy in the promoted type of
    X, obs3, P_mats and F_table.  CUDA tensors launch kernel K7 (T <= 64)
    as launch_plan lays it out, the launches after the first on streams of
    their own that the current stream then waits for; CPU tensors take the
    plain version."""
    if X.device.type == "cpu":
        return _expand_chains_compact_plain(
            plg_coords, grids, P_mats, F_table, cell, X, obs3, cams3,
            chain_idx, t_idx, item_ok, chain_valid, cfg, C, T)
    if not 1 <= T <= 64:
        raise ValueError(f"expand_chains: chains of T={T} slots (kernel K7 "
                         f"takes T <= 64)")
    V, GH, GW, Kc, _ = grids.shape
    K = X.shape[0]
    Omax = min(V, max(cfg.max_obs_per_point, 4))
    dt = kernels.require_float(
        kernels.compute_dtype(X, obs3, P_mats, F_table), "expand_chains")
    X = X.to(dt).clone(memory_format=torch.contiguous_format)
    grids, P_mats, F_table, obs3, cams3, chain_valid = (
        t.contiguous() for t in (grids, P_mats.to(dt), F_table.to(dt),
                                 obs3.to(dt), cams3, chain_valid))
    kernels.require(grids, "grids", torch.float32, (V, GH, GW, Kc, 6),
                    align=8)
    kernels.require(P_mats, "P_mats", dt, (V, 3, 4))
    kernels.require(F_table, "F_table", dt, (V, V, 3, 3))
    kernels.require(X, "X", dt, (K, 3))
    kernels.require(obs3, "obs3", dt, (K, 3, 2))
    kernels.require(cams3, "cams3", torch.int32, (C, 3))
    kernels.require(chain_valid, "chain_valid", torch.bool, (C, T))
    dev = X.device
    out_xy, out_ok = _initial_outputs(obs3, cams3[chain_idx.long()],
                                      item_ok, V)
    if K == 0 or C == 0:
        return X, out_xy, out_ok
    if len(extent) != C:
        raise ValueError(f"expand_chains: extent of {len(extent)} chains, "
                         f"expected {C}")
    slots = _chain_slots(chain_idx, t_idx, item_ok, C, T)
    epipolar = cfg.expand_correspondence_mode == "epipolar"
    plan = launch_plan(extent)
    order = torch.as_tensor(plan.order, device=dev)
    cam_buf = torch.empty((K, Omax), dtype=torch.int32, device=dev)
    obs_x = torch.empty((K, Omax), dtype=dt, device=dev)
    obs_y = torch.empty((K, Omax), dtype=dt, device=dev)
    entry = "eg3d_expand_chains" if dt == torch.float32 else \
        "eg3d_expand_chains_f64"
    with kernels.on_device(X):
        main = torch.cuda.current_stream(dev)
        streams = [main] + _side_streams(dev)[:len(plan.launches) - 1]
        for s in streams[1:]:       # the inputs, before any launch
            s.wait_stream(main)
        for launch, s in zip(plan.launches, streams):
            rc = getattr(kernels.lib(), entry)(
                grids.data_ptr(), V, GH, GW, Kc, float(cell),
                P_mats.data_ptr(), F_table.data_ptr(), obs3.data_ptr(),
                cams3.data_ptr(), slots.data_ptr(), chain_valid.data_ptr(),
                order.data_ptr() + order.element_size() * launch.first,
                launch.bucket, launch.n, T, Omax,
                float(math.sqrt(cfg.expand_max_projection_distsq)),
                int(epipolar), float(cfg.quasiparallel_cos),
                cfg.follow_gn_iters, float(cfg.gn_epsilon),
                float(cfg.match_gn_max_mse), 1e-5,
                kernels.place("expand_chains", k7_table_bytes(
                    V, epipolar, dt, pairs=launch.bucket == 3), dev),
                X.data_ptr(), cam_buf.data_ptr(),
                obs_x.data_ptr(), obs_y.data_ptr(), out_xy.data_ptr(),
                out_ok.data_ptr(), s.cuda_stream)
            kernels.check(rc, "expand_chains")
            kernels.count_launch("expand_chains", dt)
        for s in streams[1:]:
            main.wait_stream(s)
    return X, out_xy, out_ok


def group_chains(seed_ids: np.ndarray, orders: np.ndarray,
                 max_t: int = 64):
    """Group flat chain rows into padded [C, T<=max_t] index tensors.

    Rows of one seed sorted by signed chain order form the chain
    (backward sweep reversed, seed, forward sweep); chains longer than
    max_t are split into consecutive pieces (continuity runs are cut at
    piece boundaries — a bounded-recall tradeoff for fixed shapes).

    Returns (gather_idx [C, max_t] int64 into the flat rows, valid
    [C, max_t]).
    """
    n = len(seed_ids)
    if n == 0:
        return (np.zeros((0, max_t), np.int64),
                np.zeros((0, max_t), bool))
    order = np.lexsort((orders, seed_ids))
    sid = seed_ids[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sid)) + 1, [n]])
    gather, valid = [], []
    for a, b in zip(starts[:-1], starts[1:]):
        for lo in range(a, b, max_t):
            hi = min(lo + max_t, b)
            pad = max_t - (hi - lo)
            gather.append(np.pad(order[lo:hi], (0, pad)))
            valid.append(np.pad(np.ones(hi - lo, bool), (0, pad)))
    return np.stack(gather), np.stack(valid)
