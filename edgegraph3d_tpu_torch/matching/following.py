"""PLG following: sweeping 3D edge chains from seed matches.

Port of edgegraph3d_tpu/matching/following.py.  One call of kernel K4
(`follow_walk`, csrc/follow_walk.cu) is the whole follow: one CUDA thread
per seed lane loops up to `max_steps` times — advance 10 px on the
driving view, intersect the two epipolar lines on the other tuple views
within [5, 20] px, triangulate the three observations (DLT + GN, or GN
warm-started from the seed) — and the chain ends at its first walk or GN
failure, as in the reference's walk.  The JAX package runs the GN once
after the walk over the live steps and cuts each chain at its first
failure; the result is the same, and `_follow_plain` (the CPU path) is
that composition.

Direction resolution tries 3 driving views x 4 direction combos for one
step each (K4 with max_steps=1, GN warm-started from the seed) and keeps
the first valid configuration, d-major then combos.

The follow computes in the promoted type of the polylines, F, P and the
seeds' positions: f32, or f64 under EdgeGraphConfig(dtype="float64"),
where K4 launches its f64 body and the walk's multiply-adds are the
correctly rounded f64 ones (ops.geometry._fma).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.ops import polyline_ops as po
from edgegraph3d_tpu_torch.ops.geometry import epipolar_line
from edgegraph3d_tpu_torch.ops.triangulation import _triangulate_gn_plain

DET_MIN = 1e-5      # the GN's singular guard (triangulation defaults)


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


class Follow(NamedTuple):
    """K4's output, in the lanes' permuted tuple order.  Steps after the
    cut are zero, except that the step whose GN failed keeps its walk
    observation, seg and t (with valid False)."""
    valid: torch.Tensor      # [S,T] bool, accepted steps (a prefix)
    n_steps: torch.Tensor    # [S] int32
    X: torch.Tensor          # [S,T,3]
    obs: torch.Tensor        # [S,T,3,2]
    seg: torch.Tensor        # [S,T,3] int32
    t: torch.Tensor          # [S,T,3]
    final_seg: torch.Tensor  # [S,3] int32, the last accepted position
    final_t: torch.Tensor    # [S,3]   (the start when none)


def _walk_plain(coords, lengths, F_table, cams, pl, seg0, t0, xy0, dirs,
                active0, T: int, step: float, min_d: float, max_d: float,
                qcos: float, qdist: float) -> Walk:
    """The walk alone, vectorized over lanes: every step until a lane's
    first walk failure, without triangulating."""
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


def _follow_plain(coords, lengths, F_table, P_mats, cams, pl, seg0, t0, xy0,
                  dirs, active0, X0, T: int, step: float, min_d: float,
                  max_d: float, qcos: float, qdist: float, gn_iters: int,
                  epsilon: float, accept_mse: float) -> Follow:
    """Plain twin of K4, the JAX package's composition: the walk, then
    the plain DLT + GN (or GN from X0) over the walk's live steps, then
    each chain cut at its first GN failure.  Runs in the float inputs'
    promoted type, as the kernel does."""
    fdt = kernels.compute_dtype(coords, F_table, P_mats, t0, xy0, X0)
    coords, F_table, P_mats, t0, xy0 = (
        a.to(fdt) for a in (coords, F_table, P_mats, t0, xy0))
    X0 = None if X0 is None else X0.to(fdt)
    walk = _walk_plain(coords, lengths, F_table, cams, pl, seg0, t0, xy0,
                       dirs, active0, T, step, min_d, max_d, qcos, qdist)
    S = cams.shape[0]
    dev = xy0.device
    rows = torch.nonzero(walk.alive.reshape(-1)).flatten()
    gn_ok = torch.zeros(S * T, dtype=torch.bool, device=dev)
    Xs = torch.zeros((S * T, 3), dtype=xy0.dtype, device=dev)
    if len(rows):
        lane = rows // T
        Xr, _, ok = _triangulate_gn_plain(
            P_mats, cams[lane], walk.obs.reshape(S * T, 3, 2)[rows],
            torch.ones((len(rows), 3), dtype=torch.bool, device=dev),
            None if X0 is None else X0[lane], gn_iters, epsilon,
            accept_mse, DET_MIN)
        gn_ok[rows] = ok
        Xs[rows] = Xr
    gn_ok = gn_ok.reshape(S, T)
    valid = walk.alive & torch.cumprod((gn_ok | ~walk.alive)
                                       .to(torch.int32), dim=1).bool()
    n_steps = valid.sum(1).to(torch.int32)
    keep = walk.alive & (torch.arange(T, device=dev)[None, :]
                         <= n_steps[:, None])
    ar = torch.arange(S, device=dev)
    last = torch.clamp_min(n_steps - 1, 0).long()
    moved = (n_steps > 0)[:, None]
    return Follow(
        valid=valid, n_steps=n_steps,
        X=torch.where(valid[..., None], Xs.reshape(S, T, 3), 0.0),
        obs=torch.where(keep[..., None, None], walk.obs, 0.0),
        seg=torch.where(keep[..., None], walk.seg, 0),
        t=torch.where(keep[..., None], walk.t, 0.0),
        final_seg=torch.where(moved, walk.seg[ar, last], seg0),
        final_t=torch.where(moved, walk.t[ar, last], t0))


def follow_params(cfg, warm: bool):
    """(walk, gn) parameters of K4 and its plain twin from `cfg`: the walk
    distances and quasi-parallel gates, then (iterations, epsilon,
    accepted MSE) of the GN, warm (from X0) or cold (DLT first)."""
    walk = (cfg.follow_first_image_dist_px, cfg.follow_min_dist_px,
            cfg.follow_max_dist_px, cfg.quasiparallel_cos,
            cfg.quasiparallel_dist_px)
    gn = (cfg.follow_gn_iters if warm else cfg.gn_max_iters, cfg.gn_epsilon,
          cfg.match_gn_max_mse)
    return walk, gn


def follow_walk(coords, lengths, F_table, P_mats, cams, pl, seg0, t0, xy0,
                dirs, active0, X0, T: int, cfg) -> Follow:
    """Kernel K4.  coords [V,P,L,2], lengths [V,P] i32, F_table
    [V,V,3,3], P_mats [V,3,4]; per lane (permuted tuple order, driving
    view first): cams/pl/seg0/dirs [S,3] i32, t0 [S,3], xy0 [S,3,2],
    active0 [S] bool, X0 [S,3] or None.  Follows every lane for at most
    T steps with the walk distances and GN gates of `cfg`: cold (X0
    None) DLT + cfg.gn_max_iters GN iterations per step, warm (GN from
    X0) cfg.follow_gn_iters.  The float inputs' promoted type (f32 or
    f64) is the follow's; CUDA tensors launch the kernel's
    instantiation for it; CPU tensors take the plain twin."""
    walk, gn = follow_params(cfg, X0 is not None)
    if xy0.device.type == "cpu":
        return _follow_plain(coords, lengths, F_table, P_mats, cams, pl,
                             seg0, t0, xy0, dirs, active0, X0, T, *walk,
                             *gn)
    V, P, L, _ = coords.shape
    S = cams.shape[0]
    fdt = kernels.require_float(
        kernels.compute_dtype(coords, F_table, P_mats, t0, xy0, X0),
        "follow_walk")
    args = [t.contiguous() for t in (coords.to(fdt), lengths,
                                     F_table.to(fdt), P_mats.to(fdt), cams,
                                     pl, seg0, t0.to(fdt), xy0.to(fdt), dirs,
                                     active0)]
    coords, lengths, F_table, P_mats, cams, pl, seg0, t0, xy0, dirs, \
        active0 = args
    kernels.require(coords, "coords", fdt, (V, P, L, 2))
    kernels.require(lengths, "lengths", torch.int32, (V, P))
    kernels.require(F_table, "F_table", fdt, (V, V, 3, 3))
    kernels.require(P_mats, "P_mats", fdt, (V, 3, 4))
    for name, a, dt in (("cams", cams, torch.int32), ("pl", pl, torch.int32),
                        ("seg0", seg0, torch.int32), ("t0", t0, fdt),
                        ("dirs", dirs, torch.int32)):
        kernels.require(a, name, dt, (S, 3))
    kernels.require(xy0, "xy0", fdt, (S, 3, 2))
    kernels.require(active0, "active0", torch.bool, (S,))
    if X0 is not None:
        X0 = X0.to(fdt).contiguous()
        kernels.require(X0, "X0", fdt, (S, 3))
    dev = xy0.device
    flt = dict(dtype=fdt, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = Follow(valid=torch.zeros((S, T), dtype=torch.bool, device=dev),
                 n_steps=torch.empty(S, **i32),
                 X=torch.zeros((S, T, 3), **flt),
                 obs=torch.zeros((S, T, 3, 2), **flt),
                 seg=torch.zeros((S, T, 3), **i32),
                 t=torch.zeros((S, T, 3), **flt),
                 final_seg=torch.empty((S, 3), **i32),
                 final_t=torch.empty((S, 3), **flt))
    if S == 0:
        return out
    counter = torch.zeros(1, **i32)
    entry = "eg3d_follow_walk" if fdt == torch.float32 else \
        "eg3d_follow_walk_f64"
    with kernels.on_device(xy0):
        rc = getattr(kernels.lib(), entry)(
            coords.data_ptr(), lengths.data_ptr(), V, P, L, F_table.data_ptr(),
            P_mats.data_ptr(), cams.data_ptr(), pl.data_ptr(), seg0.data_ptr(),
            t0.data_ptr(), xy0.data_ptr(), dirs.data_ptr(), active0.data_ptr(),
            kernels.ptr(X0), S, T, *(float(w) for w in walk), int(gn[0]),
            float(gn[1]), float(gn[2]), DET_MIN, counter.data_ptr(),
            *(a.data_ptr() for a in out), kernels.stream_of(xy0))
    kernels.check(rc, "follow_walk")
    kernels.count_launch("follow_walk", fdt)
    return out


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
    oks = follow_walk(plg_coords, plg_length, F_table, P_mats, cams, pl,
                      seg, t, xy, dirs,
                      torch.ones(n_cfg * S, dtype=torch.bool, device=dev),
                      rep(seeds.X), 1, cfg).valid[:, 0]
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
    f = follow_walk(plg_coords, plg_length, F_table, P_mats, cams, pl, seg0,
                    t0, xy0, dirs, seeds.valid & dir_ok, None, max_steps,
                    cfg)
    obs = torch.take_along_dim(
        f.obs, inv_perm.long()[:, None, :, None].expand(S, max_steps, 3, 2),
        dim=2)
    return FollowResult(
        X=f.X, obs_xy=obs, valid=f.valid, n_steps=f.n_steps,
        final_seg=_permute(f.final_seg, inv_perm),
        final_t=_permute(f.final_t, inv_perm), perm=perm, dirs=dirs)


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
