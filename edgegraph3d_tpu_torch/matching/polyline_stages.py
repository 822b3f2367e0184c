"""Stages 1 and 2: polyline-to-polyline matching across views.

Port of edgegraph3d_tpu/matching/polyline_stages.py (see its docstring
for the reference's semantics):

  stage 1 (similarity graph): nodes are (view, polyline) pairs close to
      a common refpoint's projections (kernel K1 over every (refpoint,
      view) at M = similarity_close_cap), weighted-Jaccard edges (two
      f64 `torch.matmul` products on the card, the host clique build on
      the CPU), communities (communities.py);
  stage 2 (closeness): connected components of (view, polyline) pairs
      from unambiguous refpoints (host code, copied);
  sweep: every match-set member is sampled every 20 px and each sample
      seeds a 3-view tuple from its epipolar crossings with the other
      members: kernel K5 gathers the member polylines, kernel K6 samples
      them and intersects, K3 triangulates the 2 x 2 candidate pairs,
      and the seeds are followed by following.py (K4, K3).

Buffers are sized from counts: the JAX pow2 shapes, U_cap / E_cap /
cap_s / cap_rows and their overflow fallbacks do not exist here.  Seeds
come out in the JAX order whatever the group chunk: chunk by chunk, then
(group, member, sample) row-major.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.core.sfm import SfMData
from edgegraph3d_tpu_torch.matching import communities as comm_mod
from edgegraph3d_tpu_torch.matching import following
from edgegraph3d_tpu_torch.matching import refpoints as rp
from edgegraph3d_tpu_torch.matching.detection import (Candidates,
                                                      grid_topm_query)
from edgegraph3d_tpu_torch.ops import polyline_ops as po
from edgegraph3d_tpu_torch.ops.gather import gather_rows
from edgegraph3d_tpu_torch.ops.geometry import epipolar_line_fma
from edgegraph3d_tpu_torch.ops.triangulation import triangulate_gn
from edgegraph3d_tpu_torch.pipeline import PipelineStats

#: polyline_line_intersections' own defaults, which the JAX sweep uses
#: (not the config's quasi-parallel knobs)
_QUASI_COS = 0.965
_QUASI_DIST = 5.0


# ----------------------------------------------------------------------
# Close-polyline detection per (refpoint, view)
# ----------------------------------------------------------------------

def _close_polylines(ctx: rp.MatchingContext, obs_xy: np.ndarray, M: int,
                     within_dist: float) -> Candidates:
    """For every (refpoint, view): the top-M distinct polylines within
    `within_dist` of the observation (K1, one launch over all pairs).
    Returns host (numpy) Candidates [N, V, M], distances clamped at 1e18
    as the JAX package packs them."""
    N, V = obs_xy.shape[:2]
    view = torch.arange(V, dtype=torch.int32, device=ctx.device).repeat(N)
    pts = torch.as_tensor(obs_xy.reshape(N * V, 2), device=ctx.device)
    c = grid_topm_query(ctx.grids, view, pts, ctx.cell, within_dist, M,
                        view_cycle=True)
    host = lambda a: a.cpu().numpy().reshape((N, V) + tuple(a.shape[1:]))
    return Candidates(pl_id=host(c.pl_id), seg=host(c.seg), t=host(c.t),
                      xy=host(c.xy), dist=np.minimum(host(c.dist), 1e18),
                      valid=host(c.valid))


def _close_polylines_cached(sfmd: SfMData, ctx: rp.MatchingContext, M: int,
                            within_dist: float) -> Candidates:
    """Per-(scene, context) memo: stage 2's close set (M=2) is a prefix
    of stage 1's (the top-M lists are nested), so one sweep serves both.
    The cache lives on the context and pins a weakref to the scene."""
    cache = ctx.__dict__.setdefault("_close_polyline_cache", {})
    for (m2, d), (scene_ref, val) in cache.items():
        if scene_ref() is sfmd and d == within_dist and m2 >= M:
            return Candidates(*[a[:, :, :M] for a in val])
    obs_xy, _ = rp.dense_observations(sfmd)
    cand = _close_polylines(ctx, obs_xy, M, within_dist)
    for k in [k for k, (ref, _) in cache.items() if ref() is not sfmd]:
        del cache[k]
    cache[(M, within_dist)] = (weakref.ref(sfmd), cand)
    return cand


# ----------------------------------------------------------------------
# Stage 2: closeness match sets (host code, copied)
# ----------------------------------------------------------------------

def closeness_match_sets(sfmd: SfMData, ctx: rp.MatchingContext,
                         max_sets: int | None = None) -> list[np.ndarray]:
    """Connected components of (view, polyline) pairs from unambiguous
    refpoints.  Returns a list of [k,2] arrays (view, polyline)."""
    cfg = ctx.config
    obs_xy, obs_mask = rp.dense_observations(sfmd)
    cand = _close_polylines_cached(sfmd, ctx, 2, cfg.find_within_dist_px)
    valid = np.asarray(cand.valid) & obs_mask[..., None]   # [N,V,2]
    pl = np.asarray(cand.pl_id)
    dist = np.asarray(cand.dist)

    n_close = valid.sum(axis=2)                            # [N,V]
    unambiguous = (n_close <= 1) | ~obs_mask
    one = (n_close == 1) & obs_mask
    N, V = obs_mask.shape

    # union-find over (view, polyline) nodes
    parent: dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for n in range(N):
        if not unambiguous[n].all():
            continue
        views = np.flatnonzero(one[n])
        if len(views) < max(2, int(np.ceil(
                cfg.closeness_min_view_coverage * obs_mask[n].sum()))):
            continue
        d = dist[n, views, 0]
        if d.max() > cfg.closeness_max_dist_ratio * max(d.min(), 1e-6):
            continue
        nodes = [(int(v), int(pl[n, v, 0])) for v in views]
        for other in nodes[1:]:
            union(nodes[0], other)

    groups: dict = {}
    for node in list(parent):
        groups.setdefault(find(node), []).append(node)
    out = [np.asarray(sorted(g), dtype=np.int64)
           for g in groups.values() if len(g) >= 3]
    out.sort(key=lambda g: (-len(g), g[0][0], g[0][1]))
    return out[:max_sets] if max_sets else out


# ----------------------------------------------------------------------
# Stage 1: similarity graph + communities
# ----------------------------------------------------------------------

def _similarity_edges_device(nn, u_idx, w_ref, obs_mask, view_of_u,
                             device):
    """Similarity-graph edges as two dense matmuls (the JAX package's
    device path).  With B [N, U] the refpoint x node close-incidence
    matrix:
      inter_w[a, b] = (B^T diag(w) B)[a, b]
      SA[a, v]      = (B^T diag(w) Obs)[a, v]
      union_w[a, b] = SA[a, view(b)] + SA[b, view(a)] - inter_w[a, b]
      w_edge        = inter_w / union_w
    and the upper-triangle positive entries are the edges, in (a, b)
    order like the host path's.  The products run in f64 (the H100's FP64
    tensor cores): the JAX package asks for bf16 passes here, but in f64
    the sums differ from the host path's f64 sums only in rounding order,
    so the f32 weights equal the host build's unless two such sums round
    to different sides of an f32 boundary (none of the 3,026,200 edges of
    the 49-view full-scale scene on an H100), and equal Jaccard fractions
    stay equal ties for label propagation.  Returns (edges [E, 2] i32,
    weights [E] f32) numpy."""
    N, V = obs_mask.shape
    U = len(view_of_u)
    f64 = dict(dtype=torch.float64, device=device)
    B = torch.zeros((N, U), **f64)
    B[torch.as_tensor(nn, device=device),
      torch.as_tensor(u_idx, device=device)] = 1.0
    Bw = B * torch.as_tensor(w_ref, **f64)[:, None]
    inter = B.T @ Bw                                          # [U, U]
    SA = Bw.T @ torch.as_tensor(obs_mask, **f64)              # [U, V]
    del B, Bw
    SA_vb = SA[:, torch.as_tensor(view_of_u, device=device)]  # SA[a, v(b)]
    union = SA_vb + SA_vb.T
    del SA_vb
    union -= inter
    w_edge = torch.where(union > 0, inter / union.clamp_min(1e-12), 0.0)
    del union
    keep = (inter > 0) & (w_edge > 0)
    del inter
    keep.triu_(1)
    ia, ib = torch.nonzero(keep, as_tuple=True)
    weights = w_edge[ia, ib].to(torch.float32)
    return (torch.stack([ia, ib], 1).to(torch.int32).cpu().numpy(),
            weights.cpu().numpy())


def _similarity_edges_host(node, valid, w_ref, obs_mask, used, nn, vv,
                           mm, u_idx, V: int, P_cnt: int):
    """Host (numpy) similarity-edge build, the CPU path (copied): clique
    pairs per refpoint, then the weighted Jaccard.  Returns (edges,
    weights) or None."""
    N = valid.shape[0]
    M = valid.shape[2]
    U = len(used)
    SA = np.zeros((U, V), dtype=np.float64)
    np.add.at(SA, u_idx, w_ref[nn, None] * obs_mask[nn])

    K = V * M
    slots_i, slots_j = np.triu_indices(K, k=1)
    node_flat = node.reshape(N, K)
    valid_flat = valid.reshape(N, K)
    keys_acc, inter_acc = [], []
    chunk = 512
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        a = node_flat[lo:hi, slots_i]
        b = node_flat[lo:hi, slots_j]
        ok = valid_flat[lo:hi, slots_i] & valid_flat[lo:hi, slots_j]
        sel = np.nonzero(ok)
        if len(sel[0]) == 0:
            continue
        aa, bb = a[sel], b[sel]
        lo_n, hi_n = np.minimum(aa, bb), np.maximum(aa, bb)
        keys_acc.append(lo_n.astype(np.int64) * (V * P_cnt) + hi_n)
        inter_acc.append(w_ref[lo + sel[0]])
    if not keys_acc:
        return None
    keys = np.concatenate(keys_acc)
    contrib = np.concatenate(inter_acc)
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    inter_w = np.bincount(inv, weights=contrib)             # [E]
    ea = (uniq_keys // (V * P_cnt)).astype(np.int64)
    eb = (uniq_keys % (V * P_cnt)).astype(np.int64)
    ia = np.searchsorted(used, ea)
    ib = np.searchsorted(used, eb)
    va = (ea // P_cnt).astype(np.int64)
    vb = (eb // P_cnt).astype(np.int64)
    union_w = SA[ia, vb] + SA[ib, va] - inter_w
    w_edge = np.where(union_w > 0, inter_w / np.maximum(union_w, 1e-12),
                      0.0)
    keep = w_edge > 0.0
    if not keep.any():
        return None
    return (np.stack([ia[keep], ib[keep]], axis=1).astype(np.int32),
            w_edge[keep].astype(np.float32))


def similarity_graph(sfmd: SfMData, ctx: rp.MatchingContext, stats=None,
                     host: bool | None = None):
    """The stage-1 similarity graph: (used [U] node ids view * P + pl,
    edges [E, 2] into `used`, weights [E] f32), or None without edges.
    The edges come from the host path when `host`, else from the matmul
    path on the context's device; by default a CUDA context takes the
    matmul path and a CPU context the host path (as the JAX package picks
    by backend).  The sub-phases are the spans stage1_close /
    stage1_graph of `stats` (a PipelineStats)."""
    cfg = ctx.config
    stats = stats if stats is not None else PipelineStats()
    with stats.span("stage1_close"):
        obs_xy, obs_mask = rp.dense_observations(sfmd)
        M = cfg.similarity_close_cap
        cand = _close_polylines_cached(sfmd, ctx, M, cfg.find_within_dist_px)
        valid = np.asarray(cand.valid) & obs_mask[..., None]   # [N,V,M]
        pl = np.asarray(cand.pl_id)

    with stats.span("stage1_graph") as sp:
        N, V = obs_mask.shape
        P_cnt = ctx.plg_coords.shape[1]
        node = np.where(valid, np.arange(V)[None, :, None] * P_cnt + pl, -1)

        # refpoint weights (compute_refpoint_weight)
        n_close = valid.sum(axis=(1, 2)).astype(np.float64)       # [N]
        n_views = np.any(valid, axis=2).sum(axis=1).astype(np.float64)
        w_ref = np.where(n_close > 0, n_views / np.maximum(n_close, 1), 0.0)

        # dense reindex of the used (view, polyline) pairs
        used = np.unique(node[valid])
        if len(used) == 0:
            return None
        nn, vv, mm = np.nonzero(valid)
        u_idx = np.searchsorted(used, node[nn, vv, mm])

        if host is None:
            host = not ctx.on_cuda
        if not host:
            res = _similarity_edges_device(
                nn, u_idx, w_ref, obs_mask, (used // P_cnt).astype(np.int64),
                ctx.device)
        else:
            res = _similarity_edges_host(node, valid, w_ref, obs_mask, used,
                                         nn, vv, mm, u_idx, V, P_cnt)
        if res is None or len(res[0]) == 0:
            return None
        sp.count = len(res[0])
    return used, res[0], res[1]


def similarity_match_sets(sfmd: SfMData, ctx: rp.MatchingContext,
                          max_sets: int | None = None,
                          stats=None) -> list[np.ndarray]:
    """Polyline-compatibility communities of the similarity graph, as
    [k, 2] (view, polyline) arrays with >= 3 distinct views, largest
    first.  The sub-phases are the spans stage1_close / graph /
    communities of `stats` (a PipelineStats); inside stage1_communities
    each host Louvain call is a span louvain."""
    stats = stats if stats is not None else PipelineStats()
    graph = similarity_graph(sfmd, ctx, stats)
    if graph is None:
        return []
    used, edges, weights = graph
    with stats.span("stage1_communities") as sp:
        comms = comm_mod.communities_from_edges(
            edges, weights, len(used), min_size=3,
            method=ctx.config.community_method, device=ctx.device,
            stats=stats)
        sp.count = len(comms)
    return communities_to_match_sets(used, comms, ctx.plg_coords.shape[1],
                                     max_sets)


def communities_to_match_sets(used: np.ndarray, comms: list[np.ndarray],
                              P_cnt: int, max_sets: int | None = None
                              ) -> list[np.ndarray]:
    """Communities of graph nodes -> [k, 2] (view, polyline) match sets
    with >= 3 distinct views, largest first."""
    out = []
    for c in comms:
        uc = used[np.asarray(c)]
        pairs = np.stack([uc // P_cnt, uc % P_cnt], axis=1)
        # need >= 3 distinct views for seeding
        if len(np.unique(pairs[:, 0])) >= 3:
            out.append(pairs)
    out.sort(key=lambda g: (-len(g), g[0][0], g[0][1]))
    return out[:max_sets] if max_sets else out


# ----------------------------------------------------------------------
# Match-set sweep: member sampling and crossings (kernel K6)
# ----------------------------------------------------------------------

def _group_seed_sample_plain(coords, lengths, cams, mask, F_table,
                             n_samples: int, spacing: float, qcos: float,
                             qdist: float):
    """Plain twin of K6: sample_interval_points over every member, the
    normalized epipolar line of every sample into every member's view,
    and polyline_line_intersections (first two crossings) of each line
    with that member's polyline."""
    G, K, L, _ = coords.shape
    S = n_samples
    s_xy, s_seg, s_t, s_valid = po.sample_interval_points(
        coords.reshape(G * K, L, 2), lengths.reshape(-1), spacing, S)
    s_xy = s_xy.reshape(G, K, S, 2)
    s_seg, s_t = s_seg.reshape(G, K, S), s_t.reshape(G, K, S)
    s_valid = s_valid.reshape(G, K, S) & mask[..., None]
    cs = cams.clamp_min(0).long()
    F_pair = F_table[cs[:, :, None], cs[:, None, :]]           # [G,K,K,3,3]
    lines = epipolar_line_fma(F_pair[:, :, None],
                              s_xy[:, :, :, None, :])          # [G,K,S,K,3]
    i_xy, i_seg, i_t, i_ok = po.polyline_line_intersections(
        coords[:, None, None].expand(G, K, S, K, L, 2).reshape(-1, L, 2),
        lengths[:, None, None].expand(G, K, S, K).reshape(-1),
        lines.reshape(-1, 3), 2, qcos, qdist)
    usable = mask[:, None, None, :] \
        & (cams[:, :, None] != cams[:, None, :])[:, :, None, :]
    i_ok = i_ok.reshape(G, K, S, K, 2) & usable[..., None] \
        & s_valid[..., None, None]
    return (s_xy, s_seg, s_t, s_valid, i_xy.reshape(G, K, S, K, 2, 2),
            i_seg.reshape(G, K, S, K, 2), i_t.reshape(G, K, S, K, 2), i_ok)


def k6_table_bytes(K: int, L: int) -> int:
    """Bytes of K6's per-group member table: K polylines [K, L, 2] f32
    and their lengths, cameras and masks as int32 (csrc
    group_seed_sample.cu eg3d_group_seed_sample_smem)."""
    return K * (8 * L + 12)


def group_seed_sample(coords, lengths, cams, mask, F_table, n_samples: int,
                      spacing: float, qcos: float = _QUASI_COS,
                      qdist: float = _QUASI_DIST):
    """Kernel K6.  coords [G,K,L,2] f32 member polylines, lengths [G,K]
    i32 (0 for absent members), cams [G,K] i32 (-1 absent), mask [G,K]
    bool, F_table [V,V,3,3] f32.  Returns (s_xy [G,K,S,2], s_seg, s_t,
    s_valid [G,K,S], i_xy [G,K,S,K,2,2], i_seg, i_t, i_ok [G,K,S,K,2]):
    the interval samples of every member (s_valid includes the member
    mask) and the first two crossings of each sample's epipolar line
    with every member's polyline (i_ok includes the member mask, the
    different-camera rule and s_valid).  CUDA tensors launch one block
    per group, its member table placed by kernels.table_placement (so
    any K runs); CPU tensors take the plain twin."""
    if coords.device.type == "cpu":
        return _group_seed_sample_plain(coords, lengths, cams, mask,
                                        F_table, n_samples, spacing, qcos,
                                        qdist)
    G, K, L, _ = coords.shape
    V = F_table.shape[0]
    S = n_samples
    args = [t.contiguous() for t in (coords, lengths, cams, mask, F_table)]
    coords, lengths, cams, mask, F_table = args
    kernels.require(coords, "coords", torch.float32, (G, K, L, 2))
    kernels.require(lengths, "lengths", torch.int32, (G, K))
    kernels.require(cams, "cams", torch.int32, (G, K))
    kernels.require(mask, "mask", torch.bool, (G, K))
    kernels.require(F_table, "F_table", torch.float32, (V, V, 3, 3))
    if L < 3 or S < 1:
        raise ValueError(f"group_seed_sample: needs L >= 3 and n_samples "
                         f">= 1, got L={L}, n_samples={S}")
    dev = coords.device
    f = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    out = (torch.empty((G, K, S, 2), **f), torch.empty((G, K, S), **i32),
           torch.empty((G, K, S), **f), torch.empty((G, K, S), **b),
           torch.empty((G, K, S, K, 2, 2), **f),
           torch.empty((G, K, S, K, 2), **i32),
           torch.empty((G, K, S, K, 2), **f),
           torch.empty((G, K, S, K, 2), **b))
    if G == 0 or K == 0:
        return out
    with kernels.on_device(coords):
        rc = kernels.lib().eg3d_group_seed_sample(
            coords.data_ptr(), lengths.data_ptr(), cams.data_ptr(),
            mask.data_ptr(), G, K, L, F_table.data_ptr(), V, S, float(spacing),
            float(qcos), float(qdist),
            kernels.place("group_seed_sample", k6_table_bytes(K, L), dev),
            *(o.data_ptr() for o in out), kernels.stream_of(coords))
    kernels.check(rc, "group_seed_sample")
    kernels.count_launch("group_seed_sample", torch.float32)
    return out


# ----------------------------------------------------------------------
# Match-set sweep: seeding and following
# ----------------------------------------------------------------------

def _take_member(a, j):
    """a [G,K,S,n,...] at index j [G,K,S] along dim 3 -> [G,K,S,...]."""
    idx = j.reshape(j.shape + (1,) * (a.ndim - 3))
    return torch.take_along_dim(a, idx, dim=3).squeeze(3)


def _group_seed_sweep(ctx: rp.MatchingContext, grp_cam, grp_pl, grp_mask,
                      n_samples: int) -> dict:
    """Seeds from interval samples of match-set polylines.

    grp_cam / grp_pl / grp_mask [G, K] on the context's device.  Member
    rows come from K5, samples and crossings from K6; then per sample
    the members on the lowest and highest camera with a crossing, the
    2 x 2 candidate pairs through K3 at match_gn_max_mse, and a seed
    where exactly one pair triangulates.  Returns dense seed fields
    [G, K, S, ...] with `valid`."""
    cfg = ctx.config
    dev = ctx.device
    V, P, L, _ = ctx.plg_coords.shape
    G, K = grp_cam.shape
    S = n_samples
    cam_safe = grp_cam.clamp_min(0).long()
    pl_safe = grp_pl.clamp_min(0).long()
    coords = gather_rows(ctx.plg_coords.reshape(V * P, 2 * L),
                         (cam_safe * P + pl_safe).reshape(-1)) \
        .reshape(G, K, L, 2)
    lengths = torch.where(grp_mask, ctx.plg_length[cam_safe, pl_safe], 0) \
        .to(torch.int32)
    s_xy, s_seg, s_t, s_valid, i_xy, i_seg, i_t, i_ok = group_seed_sample(
        coords, lengths, grp_cam, grp_mask, ctx.F_table, S,
        cfg.split_interval_distance_px)

    # two members on distinct cams: (first min cam, first max cam) among
    # the members with a crossing
    memb_has = i_ok.any(-1)                                     # [G,K,S,K]
    cam_b = grp_cam[:, None, None, :].expand(G, K, S, K)
    jj = torch.arange(K, device=dev)
    lo_c = torch.where(memb_has, cam_b, 10 ** 6)
    hi_c = torch.where(memb_has, cam_b, -1)
    j1 = torch.where(lo_c == lo_c.amin(-1, keepdim=True), jj, K).amin(-1)
    j2 = torch.where(hi_c == hi_c.amax(-1, keepdim=True), jj, K).amin(-1)
    cam_j1 = _take_member(cam_b, j1)
    cam_j2 = _take_member(cam_b, j2)
    ok2 = (memb_has.sum(-1) >= 2) & (cam_j1 != cam_j2)
    c1 = [_take_member(a, j1) for a in (i_xy, i_seg, i_t, i_ok)]
    c2 = [_take_member(a, j2) for a in (i_xy, i_seg, i_t, i_ok)]
    pl_b = grp_pl[:, None, None, :].expand(G, K, S, K)
    pl_j1, pl_j2 = _take_member(pl_b, j1), _take_member(pl_b, j2)

    # triangulate the 2x2 candidate pairs; a seed needs a unique one
    cam_s = grp_cam[:, :, None].expand(G, K, S)
    cams3 = torch.stack([cam_s, cam_j1, cam_j2], -1)             # [G,K,S,3]
    cand = c1[3][..., :, None] & c2[3][..., None, :] & ok2[..., None, None]
    n_lane = G * K * S
    rows = torch.nonzero(cand.reshape(-1)).flatten()
    r, i1, i2 = rows // 4, (rows // 2) % 2, rows % 2
    okt = torch.zeros(n_lane * 4, dtype=torch.bool, device=dev)
    Xp = torch.zeros((n_lane * 4, 3), dtype=torch.float32, device=dev)
    if len(rows):
        pair_xy = torch.stack([s_xy.reshape(-1, 2)[r],
                               c1[0].reshape(-1, 2, 2)[r, i1],
                               c2[0].reshape(-1, 2, 2)[r, i2]], 1)
        Xr, _, okr = triangulate_gn(
            ctx.P_mats, cams3.reshape(-1, 3)[r].clamp_min(0), pair_xy,
            torch.ones((len(rows), 3), dtype=torch.bool, device=dev),
            max_iters=cfg.gn_max_iters, epsilon=cfg.gn_epsilon,
            accept_mse=cfg.match_gn_max_mse)
        okt[rows] = okr
        Xp[rows] = Xr
    okt = okt.reshape(G, K, S, 4)
    unique = okt.sum(-1) == 1
    pick = torch.where(okt, torch.arange(4, device=dev), 4).amin(-1) \
        .clamp_max(3)
    p1, p2 = pick // 2, pick % 2
    sel = _take_member
    return dict(
        cams=cams3,
        pl_id=torch.stack([grp_pl[:, :, None].expand(G, K, S), pl_j1,
                           pl_j2], -1),
        seg=torch.stack([s_seg, sel(c1[1], p1), sel(c2[1], p2)], -1),
        t=torch.stack([s_t, sel(c1[2], p1), sel(c2[2], p2)], -1),
        xy=torch.stack([s_xy, sel(c1[0], p1), sel(c2[0], p2)], -2),
        X=sel(Xp.reshape(G, K, S, 4, 3), pick),
        valid=unique & s_valid & ok2)


def _member_table(groups: list[np.ndarray], max_members: int):
    """Match sets -> [G, max_members] (cam, pl, mask), members truncated
    at max_members in the sets' order."""
    G = len(groups)
    cam = np.full((G, max_members), -1, dtype=np.int32)
    pl = np.zeros((G, max_members), dtype=np.int32)
    msk = np.zeros((G, max_members), dtype=bool)
    for g, pairs in enumerate(groups):
        k = min(len(pairs), max_members)
        cam[g, :k] = pairs[:k, 0]
        pl[g, :k] = pairs[:k, 1]
        msk[g, :k] = True
    return cam, pl, msk


def _chunk_seeds(ctx, table, lo: int, hi: int, n_samples: int) -> dict:
    cam, pl, msk = (torch.as_tensor(a[lo:hi], device=ctx.device)
                    for a in table)
    out = _group_seed_sweep(ctx, cam, pl, msk, n_samples)
    return rp._pack_seed_outputs(out)


#: the refusal of stages 1 and 2 under dtype="float64" (pipeline
#: check_stages): the JAX package's group-seed sweep fails there
F64_REFUSAL = (
    "dtype='float64' runs stage 3 only: stages 1 and 2 fail in the JAX "
    "reference under x64 (edgegraph3d_tpu/ops/polyline_ops.py:294, "
    "sample_interval_points' f32 scan carry), so pass stages=(3,)")


def group_seeds_and_follow(groups: list[np.ndarray],
                           ctx: rp.MatchingContext, n_samples: int = 24,
                           max_members: int = 8, group_chunk: int = 64):
    """Seeding + bidirectional following, chunk by chunk over match sets
    (the following sharded over ctx.mesh when there is one).  Returns
    (round0 list for sweep_seeds(precomputed=...), n_seeds_total) or
    (None, 0).  An f64 context raises F64_REFUSAL, as the JAX sweep
    fails on one."""
    if ctx.plg_coords.dtype != torch.float32:
        raise NotImplementedError(F64_REFUSAL)
    if not groups:
        return None, 0
    cfg = ctx.config
    table = _member_table(groups, max_members)
    round0 = []
    seed_lo = 0
    for lo in range(0, len(groups), group_chunk):
        hi = min(lo + group_chunk, len(groups))
        seeds = _chunk_seeds(ctx, table, lo, hi, n_samples)
        n_seeds = len(seeds["cams"])
        if n_seeds == 0:
            continue
        st = rp._seed_tuple(seeds)
        fwd, bwd = rp.follow_bidirectional(ctx, st)
        rows, meta = following.pack_follow_outputs(
            fwd, bwd, st.valid, cfg.new_point_min_steps)
        round0.append((seed_lo, rp._seeds_to_host(seeds, lo),
                       rows.cpu().numpy(), meta.cpu().numpy()))
        seed_lo += n_seeds
    return (round0 if round0 else None), seed_lo


def seeds_from_match_sets(groups: list[np.ndarray], ctx: rp.MatchingContext,
                          n_samples: int = 24, max_members: int = 8,
                          group_chunk: int = 64):
    """The group sweep over all match sets without following; returns
    (seeds_np dict, group ids) for sweep_seeds, or (None, None)."""
    if not groups:
        return None, None
    table = _member_table(groups, max_members)
    parts = []
    for lo in range(0, len(groups), group_chunk):
        hi = min(lo + group_chunk, len(groups))
        seeds = _chunk_seeds(ctx, table, lo, hi, n_samples)
        if len(seeds["cams"]):
            parts.append(rp._seeds_to_host(seeds, lo))
    if not parts:
        return None, None
    keys = ("cams", "pl_id", "seg", "t", "xy", "X")
    return ({k: np.concatenate([p[k] for p in parts]) for k in keys},
            np.concatenate([p["_ref"] for p in parts]))
