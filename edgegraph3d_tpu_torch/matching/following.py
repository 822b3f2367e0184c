"""PLG following: sweeping 3D edge chains from seed matches.

Port of edgegraph3d_tpu/matching/following.py.  The walk is kernel K4
(`follow_walk`, csrc/follow_walk.cu): one CUDA thread per seed lane
loops up to `max_steps` times — advance 10 px on the driving view,
intersect the two epipolar lines on the other tuple views within
[5, 20] px — and records every step.  Triangulation does not feed back
into the walk, so the GN acceptance (kernel K3) runs once afterwards on
the live steps, and each chain is cut at its first GN failure.

Direction resolution tries 3 driving views x 4 direction combos for one
step each (K4 with max_steps=1, then K3 warm-started from the seed) and
keeps the first valid configuration, d-major then combos.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.ops import polyline_ops as po
from edgegraph3d_tpu_torch.ops.geometry import epipolar_line
from edgegraph3d_tpu_torch.ops.triangulation import triangulate_gn


class SeedTuple(NamedTuple):
    """Validated 3-view seeds (batched over seeds [S])."""
    cams: torch.Tensor     # [S,3] int32 camera ids (0 = driving view)
    pl_id: torch.Tensor    # [S,3] int32 polyline ids
    seg: torch.Tensor      # [S,3] int32
    t: torch.Tensor        # [S,3]
    xy: torch.Tensor       # [S,3,2]
    X: torch.Tensor        # [S,3] seed 3D point
    valid: torch.Tensor    # [S] bool


class FollowResult(NamedTuple):
    X: torch.Tensor          # [S,T,3] swept 3D points
    obs_xy: torch.Tensor     # [S,T,3,2] per-tuple-view 2D points
    valid: torch.Tensor      # [S,T]
    n_steps: torch.Tensor    # [S] accepted steps
    final_seg: torch.Tensor  # [S,3] last accepted position (caller order)
    final_t: torch.Tensor    # [S,3]
    perm: torch.Tensor       # [S,3] chosen tuple permutation (driving=0)
    dirs: torch.Tensor       # [S,3] walk directions in PERMUTED order


class Walk(NamedTuple):
    obs: torch.Tensor        # [S,T,3,2] new positions per step
    seg: torch.Tensor        # [S,T,3] int32
    t: torch.Tensor          # [S,T,3]
    alive: torch.Tensor      # [S,T] bool (zeros after a lane's death)


def _walk_plain(coords, lengths, F_table, cams, pl, seg0, t0, xy0, dirs,
                active0, T: int, step: float, min_d: float, max_d: float,
                qcos: float, qdist: float) -> Walk:
    """Plain twin of K4: the same walk, vectorized over lanes."""
    S = cams.shape[0]
    dev = xy0.device
    ci, pi = cams.long(), pl.long()
    c = coords[ci, pi]                                    # [S,3,L,2]
    px, py = c[..., 0], c[..., 1]
    ln = lengths[ci, pi]                                  # [S,3]
    F_pairs = torch.stack([F_table[ci[:, 0], ci[:, 1]],
                           F_table[ci[:, 0], ci[:, 2]]], 1)   # [S,2,3,3]
    seg, t, xy = seg0.clone(), t0.clone(), xy0.clone()
    active = active0.clone()
    obs = torch.zeros((S, T, 3, 2), dtype=xy0.dtype, device=dev)
    segb = torch.zeros((S, T, 3), dtype=torch.int32, device=dev)
    tb = torch.zeros((S, T, 3), dtype=t0.dtype, device=dev)
    alive = torch.zeros((S, T), dtype=torch.bool, device=dev)
    for i in range(T):
        if not bool(active.any()):
            break
        adv = po.advance_by_distance_xy(px[:, 0], py[:, 0], ln[:, 0],
                                        seg[:, 0], xy[:, 0], dirs[:, 0],
                                        step)
        lines = epipolar_line(F_pairs, adv.xy[:, None, :])    # [S,2,3]
        ot = po.next_intersection_bounded_xy(
            px[:, 1:].reshape(2 * S, -1), py[:, 1:].reshape(2 * S, -1),
            ln[:, 1:].reshape(-1), seg[:, 1:].reshape(-1),
            t[:, 1:].reshape(-1), xy[:, 1:].reshape(-1, 2),
            dirs[:, 1:].reshape(-1), lines.reshape(-1, 3), min_d, max_d,
            qcos, qdist)
        o_found = ot.found.reshape(S, 2)
        ok = active & adv.found & o_found[:, 0] & o_found[:, 1]
        nseg = torch.cat([adv.seg[:, None], ot.seg.reshape(S, 2)], 1)
        nt = torch.cat([adv.t[:, None], ot.t.reshape(S, 2)], 1)
        nxy = torch.cat([adv.xy[:, None], ot.xy.reshape(S, 2, 2)], 1)
        seg = torch.where(ok[:, None], nseg, seg)
        t = torch.where(ok[:, None], nt, t)
        xy = torch.where(ok[:, None, None], nxy, xy)
        obs[:, i] = torch.where(ok[:, None, None], nxy, 0.0)
        segb[:, i] = torch.where(ok[:, None], nseg, 0)
        tb[:, i] = torch.where(ok[:, None], nt, 0.0)
        alive[:, i] = ok
        active = ok
    return Walk(obs=obs, seg=segb, t=tb, alive=alive)


def follow_walk(coords, lengths, F_table, cams, pl, seg0, t0, xy0, dirs,
                active0, T: int, step: float, min_d: float, max_d: float,
                qcos: float, qdist: float) -> Walk:
    """Kernel K4.  coords [V,P,L,2] f32, lengths [V,P] i32, F_table
    [V,V,3,3] f32; per lane (permuted tuple order, driving view first):
    cams/pl/seg0/dirs [S,3] i32, t0 [S,3], xy0 [S,3,2], active0 [S] bool.
    Returns the per-step buffers of a walk of at most T steps."""
    if xy0.device.type == "cpu":
        return _walk_plain(coords, lengths, F_table, cams, pl, seg0, t0,
                           xy0, dirs, active0, T, step, min_d, max_d, qcos,
                           qdist)
    V, P, L, _ = coords.shape
    S = cams.shape[0]
    args = [t.contiguous() for t in (coords, lengths, F_table, cams, pl,
                                     seg0, t0, xy0, dirs, active0)]
    coords, lengths, F_table, cams, pl, seg0, t0, xy0, dirs, active0 = args
    kernels.require(coords, "coords", torch.float32, (V, P, L, 2))
    kernels.require(lengths, "lengths", torch.int32, (V, P))
    kernels.require(F_table, "F_table", torch.float32, (V, V, 3, 3))
    for name, a, dt in (("cams", cams, torch.int32), ("pl", pl, torch.int32),
                        ("seg0", seg0, torch.int32),
                        ("t0", t0, torch.float32),
                        ("dirs", dirs, torch.int32)):
        kernels.require(a, name, dt, (S, 3))
    kernels.require(xy0, "xy0", torch.float32, (S, 3, 2))
    kernels.require(active0, "active0", torch.bool, (S,))
    dev = xy0.device
    out = Walk(obs=torch.empty((S, T, 3, 2), dtype=torch.float32, device=dev),
               seg=torch.empty((S, T, 3), dtype=torch.int32, device=dev),
               t=torch.empty((S, T, 3), dtype=torch.float32, device=dev),
               alive=torch.empty((S, T), dtype=torch.bool, device=dev))
    if S == 0 or T == 0:
        return out
    rc = kernels.lib().eg3d_follow_walk(
        coords.data_ptr(), lengths.data_ptr(), V, P, L, F_table.data_ptr(),
        cams.data_ptr(), pl.data_ptr(), seg0.data_ptr(), t0.data_ptr(),
        xy0.data_ptr(), dirs.data_ptr(), active0.data_ptr(), S, T,
        float(step), float(min_d), float(max_d), float(qcos), float(qdist),
        out.obs.data_ptr(), out.seg.data_ptr(), out.t.data_ptr(),
        out.alive.data_ptr(), kernels.stream_of(xy0))
    kernels.check(rc, "follow_walk")
    kernels.LAUNCHES["follow_walk"] += 1
    return out


def _walk(plg_coords, plg_length, F_table, cams, pl, seg, t, xy, dirs,
          active, T: int, cfg) -> Walk:
    return follow_walk(plg_coords, plg_length, F_table, cams, pl, seg, t, xy,
                       dirs, active, T, cfg.follow_first_image_dist_px,
                       cfg.follow_min_dist_px, cfg.follow_max_dist_px,
                       cfg.quasiparallel_cos, cfg.quasiparallel_dist_px)


_PERMS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))
_COMBOS = ((1, 1), (1, -1), (-1, 1), (-1, -1))
_CONFIGS = tuple((d, c1, c2) for d in range(3) for c1, c2 in _COMBOS)


def _permute(a: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder the 3-view axis (dim 1) of `a` by perm [S, 3]."""
    idx = perm.long().reshape(perm.shape + (1,) * (a.ndim - 2))
    return torch.take_along_dim(a, idx.expand(a.shape[:1] + (3,)
                                              + a.shape[2:]), dim=1)


def resolve_configuration(seeds: SeedTuple, plg_coords, plg_length, P_mats,
                          F_table, drive_dir: torch.Tensor, cfg):
    """Try 3 driving roles x 4 direction combos for one step each; keep
    the first (d-major, then combo) whose step walks and triangulates
    (GN warm-started from the seed, cfg.follow_gn_iters iterations).
    Returns (perm [S,3], dirs [S,3], ok [S])."""
    S = seeds.cams.shape[0]
    dev = seeds.cams.device
    n_cfg = len(_CONFIGS)
    cfgs = torch.tensor(_CONFIGS, dtype=torch.int32, device=dev)     # [12,3]
    perms = torch.tensor(_PERMS, dtype=torch.int32, device=dev)
    perm = perms[cfgs[:, 0].long()][:, None].expand(n_cfg, S, 3) \
        .reshape(-1, 3)
    rep = lambda a: a.repeat((n_cfg,) + (1,) * (a.ndim - 1))
    cams = _permute(rep(seeds.cams), perm)
    pl = _permute(rep(seeds.pl_id), perm)
    seg = _permute(rep(seeds.seg), perm)
    t = _permute(rep(seeds.t), perm)
    xy = _permute(rep(seeds.xy), perm)
    dirs = torch.stack([
        rep(drive_dir.to(torch.int32).expand(S)),
        cfgs[:, 1:2].expand(n_cfg, S).reshape(-1),
        cfgs[:, 2:3].expand(n_cfg, S).reshape(-1)], 1)
    walk = _walk(plg_coords, plg_length, F_table, cams, pl, seg, t, xy, dirs,
                 torch.ones(n_cfg * S, dtype=torch.bool, device=dev), 1, cfg)
    rows = torch.nonzero(walk.alive[:, 0]).flatten()
    oks = torch.zeros(n_cfg * S, dtype=torch.bool, device=dev)
    if len(rows):
        _, _, ok = triangulate_gn(
            P_mats, cams[rows], walk.obs[rows, 0],
            torch.ones((len(rows), 3), dtype=torch.bool, device=dev),
            X0=rep(seeds.X)[rows], max_iters=cfg.follow_gn_iters,
            epsilon=cfg.gn_epsilon, accept_mse=cfg.match_gn_max_mse)
        oks[rows] = ok
    oks = oks.reshape(n_cfg, S)
    any_ok = oks.any(0)
    ids = torch.arange(n_cfg, device=dev)[:, None]
    first = torch.where(any_ok, torch.where(oks, ids, n_cfg).amin(0), 0)
    chosen = cfgs[first]
    perm = perms[chosen[:, 0].long()]
    dirs = torch.stack([drive_dir.to(torch.int32).expand(S), chosen[:, 1],
                        chosen[:, 2]], 1)
    return perm, dirs, any_ok


def follow_seeds(seeds: SeedTuple, plg_coords, plg_length, P_mats, F_table,
                 drive_dir: torch.Tensor, cfg, max_steps: int,
                 fixed_perm=None, fixed_dirs=None) -> FollowResult:
    """Sweep all seeds in one direction of the driving view.

    plg_coords [V,P,L,2], plg_length [V,P] i32, P_mats [V,3,4],
    F_table [V,V,3,3]; drive_dir [S] or scalar tensor of +-1.  The
    emitted obs_xy follow the ORIGINAL tuple view order of `seeds.cams`.
    With fixed_perm / fixed_dirs (continuation rounds) the direction
    resolve is skipped."""
    S = seeds.cams.shape[0]
    dev = seeds.cams.device
    if fixed_perm is not None:
        perm, dirs = fixed_perm.to(torch.int32), fixed_dirs.to(torch.int32)
        dir_ok = torch.ones(S, dtype=torch.bool, device=dev)
    else:
        perm, dirs, dir_ok = resolve_configuration(
            seeds, plg_coords, plg_length, P_mats, F_table, drive_dir, cfg)
    cams = _permute(seeds.cams, perm)
    seg0 = _permute(seeds.seg, perm)
    t0 = _permute(seeds.t, perm)
    xy0 = _permute(seeds.xy, perm)
    pl = _permute(seeds.pl_id, perm)
    inv_perm = torch.argsort(perm, dim=1)

    walk = _walk(plg_coords, plg_length, F_table, cams, pl, seg0, t0, xy0,
                 dirs, seeds.valid & dir_ok, max_steps, cfg)

    # GN acceptance over the live steps (s-major order), then a prefix
    # cut of each chain at its first failure
    T = max_steps
    alive_flat = walk.alive.reshape(-1)
    rows = torch.nonzero(alive_flat).flatten()
    gn_ok = torch.zeros(S * T, dtype=torch.bool, device=dev)
    Xs = torch.zeros((S * T, 3), dtype=seeds.xy.dtype, device=dev)
    if len(rows):
        Xr, _, ok = triangulate_gn(
            P_mats, cams[rows // T], walk.obs.reshape(S * T, 3, 2)[rows],
            torch.ones((len(rows), 3), dtype=torch.bool, device=dev),
            max_iters=cfg.gn_max_iters, epsilon=cfg.gn_epsilon,
            accept_mse=cfg.match_gn_max_mse)
        gn_ok[rows] = ok
        Xs[rows] = Xr
    gn_ok = gn_ok.reshape(S, T)
    ok_or_dead = gn_ok | ~walk.alive
    alive = walk.alive & torch.cumprod(ok_or_dead.to(torch.int32),
                                       dim=1).bool()
    n_steps = alive.sum(1).to(torch.int32)

    ar = torch.arange(S, device=dev)
    last = torch.clamp_min(n_steps - 1, 0).long()
    moved = (n_steps > 0)[:, None]
    fseg = torch.where(moved, walk.seg[ar, last], seg0)
    ft = torch.where(moved, walk.t[ar, last], t0)
    obs = torch.take_along_dim(
        walk.obs, inv_perm.long()[:, None, :, None].expand(S, T, 3, 2),
        dim=2)
    return FollowResult(
        X=Xs.reshape(S, T, 3), obs_xy=obs, valid=alive, n_steps=n_steps,
        final_seg=_permute(fseg, inv_perm), final_t=_permute(ft, inv_perm),
        perm=perm, dirs=dirs)


# pack_follow_outputs meta layout: [total(1), fwd final_seg(3),
# fwd final_t(3), bwd final_seg(3), bwd final_t(3), fwd n_steps(1),
# bwd n_steps(1), fwd final_xy(6), bwd final_xy(6), fwd perm(3),
# fwd dirs(3), bwd perm(3), bwd dirs(3)]
META_COLS = 39


def pack_follow_outputs(fwd: FollowResult, bwd: FollowResult,
                        seed_valid: torch.Tensor, min_steps: int):
    """Compact both directions' emitted chain points.

    Returns (rows [n, 11], meta [S, 39]); each row is [X(3), obs_xy(6),
    seed_idx(1), signed_order(1)] — fwd rows first, then bwd, each in
    (seed, step) order."""
    S, T = fwd.valid.shape
    dev = fwd.X.device
    f = fwd.X.dtype
    total = fwd.n_steps + bwd.n_steps
    keep = seed_valid & (total >= min_steps)
    sidx = torch.arange(S, dtype=f, device=dev)[:, None].expand(S, T)
    step = torch.arange(1, T + 1, dtype=f, device=dev)[None, :].expand(S, T)

    def flat(res, sign):
        val = (res.valid & keep[:, None]).reshape(-1)
        payload = torch.cat([res.X, res.obs_xy.reshape(S, T, 6),
                             sidx[..., None], (sign * step)[..., None]],
                            dim=-1).reshape(S * T, 11)
        return payload[val]

    def final_xy(res):
        last = torch.clamp_min(res.n_steps - 1, 0).long()
        return res.obs_xy[torch.arange(S, device=dev), last].reshape(S, 6)

    rows = torch.cat([flat(fwd, 1.0), flat(bwd, -1.0)])
    meta = torch.cat([
        total.to(f)[:, None],
        fwd.final_seg.to(f), fwd.final_t.to(f),
        bwd.final_seg.to(f), bwd.final_t.to(f),
        fwd.n_steps.to(f)[:, None], bwd.n_steps.to(f)[:, None],
        final_xy(fwd), final_xy(bwd),
        fwd.perm.to(f), fwd.dirs.to(f), bwd.perm.to(f), bwd.dirs.to(f)],
        dim=1)
    return rows, meta


def dead_follow_result(res: FollowResult, seeds: SeedTuple) -> FollowResult:
    """An all-invalid FollowResult shaped like `res` whose final position
    is the seed position — the 'other half' when packing a
    direction-pinned continuation sweep."""
    return FollowResult(
        X=torch.zeros_like(res.X), obs_xy=torch.zeros_like(res.obs_xy),
        valid=torch.zeros_like(res.valid),
        n_steps=torch.zeros_like(res.n_steps),
        final_seg=seeds.seg, final_t=seeds.t, perm=res.perm, dirs=res.dirs)


def follow_seeds_bidirectional(seeds: SeedTuple, plg_coords, plg_length,
                               P_mats, F_table, cfg, max_steps: int):
    """Both driving directions as one double-width batch.  Returns (fwd,
    bwd, total steps per seed)."""
    S = seeds.cams.shape[0]
    dev = seeds.cams.device
    both = SeedTuple(*[torch.cat([a, a]) for a in seeds])
    drive = torch.cat([torch.ones(S, dtype=torch.int32, device=dev),
                       -torch.ones(S, dtype=torch.int32, device=dev)])
    res = follow_seeds(both, plg_coords, plg_length, P_mats, F_table, drive,
                       cfg, max_steps)
    fwd = FollowResult(*[a[:S] for a in res])
    bwd = FollowResult(*[a[S:] for a in res])
    return fwd, bwd, fwd.n_steps + bwd.n_steps
