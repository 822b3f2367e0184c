"""Sharded sweeps and the distributed bundle adjustment.

Port of edgegraph3d_tpu/parallel/sharded.py.  Each entry takes full
tensors or host arrays (every process passes the same ones, as in the
JAX package's `shard_global` contract), runs the port's single-device
function on each local shard's contiguous block of the work-item axis
(mesh.shard_bounds), on the shard's device and against the context's
replica there (MatchingContext.on), and returns the result in global
shard order on every process (mesh.all_gather).

Every shard's launches are queued before any shard reads a result
back, so the cards of a mesh work at the same time, as shard_map's
shards do.  Following, expansion and the BA step read nothing back, so
the loop over the shards queues them all.  Seeding
compacts by count, so its functions come as step generators
(refpoints._start_sweep_steps and _seed_from_starts_steps yield right
before each read back), and `_run_shards` steps every shard to its next
yield before any goes past it.  The results are gathered once every
shard is done.  Set-up reads (the start counts between K1 and K2, the
chain bounds of expansion, K8's observation index, built once a
distributed_ba call) come before any shard's launches.  The per-point
GN (sharded_gauss_newton, off the pipeline's path) checks convergence on
the host every iteration, so its shards run one after another.

  sharded_gauss_newton          per-point GN, no collective
  sharded_start_sweep           K1 starts of a refpoint block
  sharded_seed_from_starts      K2 correspondences + K3 seeds of a block
  sharded_follow_bidirectional  K4 (+ K3) follows of a seed block
  sharded_follow_fixed          direction-pinned continuation follows
  sharded_expand_compact        K7 expansion of a block of whole chains
  distributed_ba_step / distributed_ba
                                joint LM with the points sharded: K8 per
                                shard; S, rhs, the residual sum and the
                                observation count psum'd; the 6V camera
                                solve replicated

Nothing crosses shards inside a sweep: the per-item results do not
depend on the block an item is in, so a sharded sweep equals the
single-device one.  The distributed BA's sums run in shard order, so it
differs from the single-device BA by rounding only.

`SHARD_LAUNCHES[g]` counts the kernel launches made for global shard g
(the deltas of kernels.launch_totals() around its calls and steps;
reset with `reset_shard_launches`).
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.matching import following
from edgegraph3d_tpu_torch.ops import ba as ba_ops
from edgegraph3d_tpu_torch.ops.triangulation import gauss_newton_batched
from edgegraph3d_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                                 gather_fields, psum,
                                                 shard_bounds)

SHARD_LAUNCHES: dict = {}


def reset_shard_launches() -> None:
    SHARD_LAUNCHES.clear()


def _on_shard(g: int, fn, *args, **kw):
    """fn(*args, **kw) for global shard g, its launches counted there."""
    before = kernels.launch_totals()
    out = fn(*args, **kw)
    mine = SHARD_LAUNCHES.setdefault(g, {k: 0 for k in before})
    for k, n in kernels.launch_totals().items():
        mine[k] += n - before[k]
    return out


def _step(steps):
    """(done, value): one step of a step generator."""
    try:
        next(steps)
        return False, None
    except StopIteration as done:
        return True, done.value


def _run_shards(jobs) -> list:
    """[(g, fn, args)] -> [fn(*args) of each], in the jobs' order, fn's
    launches counted for shard g.  An fn that returns a step generator
    is stepped: every shard goes to its next yield (its work queued up
    to a read back) before any goes past it."""
    out = [None] * len(jobs)
    live = []
    for i, (g, fn, args) in enumerate(jobs):
        r = _on_shard(g, fn, *args)
        if inspect.isgenerator(r):
            live.append((i, g, r))
        else:
            out[i] = r
    while live:
        still = []
        for i, g, steps in live:
            done, value = _on_shard(g, _step, steps)
            if done:
                out[i] = value
            else:
                still.append((i, g, steps))
        live = still
    return out


def _block(a, lo: int, hi: int, device) -> torch.Tensor:
    """Rows lo:hi of a tensor or host array, on `device`."""
    if isinstance(a, torch.Tensor):
        return a[lo:hi].to(device)
    return torch.as_tensor(np.ascontiguousarray(a[lo:hi]), device=device)


def _counts(mesh: Mesh, parts, key) -> torch.Tensor:
    """[size] int64: the length of each shard's part, in shard order."""
    return all_gather(mesh, [torch.tensor([len(p[key])], device=mesh.device)
                             for p in parts])


def sharded_gauss_newton(mesh: Mesh, P_obs, xy, mask, X0, **kw):
    """Per-point GN (ops.triangulation.gauss_newton_batched) with the
    point axis sharded; no collective.  Returns (X, mse, valid)."""
    outs = [_on_shard(g, gauss_newton_batched,
                      *(_block(a, lo, hi, d) for a in (P_obs, xy, mask, X0)),
                      **kw)
            for g, d, lo, hi in mesh.local_bounds(len(X0))]
    return tuple(all_gather(mesh, [o[i] for o in outs]) for i in range(3))


# ----------------------------------------------------------------------
# the distributed joint BA
# ----------------------------------------------------------------------

def _ba_shards(mesh: Mesh, state: ba_ops.BAState, obs_cam, obs_xy,
               obs_mask) -> list:
    """Per local shard: (g, device, X block, cam, xy, mask, K8's
    observation index), the index built once for all steps."""
    V = state.K.shape[0]
    out = []
    for g, d, lo, hi in mesh.local_bounds(len(state.X)):
        cam = _block(obs_cam, lo, hi, d).to(torch.int32)
        mask = _block(obs_mask, lo, hi, d)
        out.append((g, d, _block(state.X, lo, hi, d), cam,
                    _block(obs_xy, lo, hi, d), mask,
                    ba_ops.observation_index(cam, mask, V)))
    return out


def _ba_step(mesh: Mesh, cams: tuple, shards: list, damping: float):
    """One LM step over the shards: (R', t', X' blocks, mse)."""
    K, R, t = cams
    V = K.shape[0]
    parts = []
    for g, d, X, cam, xy, mask, index in shards:
        if len(X):
            st = ba_ops.BAState(K.to(d), R.to(d), t.to(d), X)
            S, blocks = _on_shard(g, ba_ops.ba_schur_local, st, cam, xy, mask,
                                  damping, index)
        else:
            S = torch.zeros((6 * V, 6 * V), dtype=K.dtype, device=d)
            blocks = None
        parts.append((S, blocks))
    # a shard with no points adds zeros of the state's type
    zero = lambda shape, dt=K.dtype: torch.zeros(shape, dtype=dt,
                                                 device=mesh.device)
    pick = lambda b, f, shape, dt=K.dtype: (
        getattr(b, f) if b is not None else zero(shape, dt))
    # the only cross-shard traffic: S, rhs, the residual sum and count
    S = psum(mesh, [p[0] for p in parts])
    rhs = psum(mesh, [pick(p[1], "rhs", (V, 6)) for p in parts])
    resid_sq = psum(mesh, [pick(p[1], "resid_sq", ()) for p in parts])
    n_obs = psum(mesh, [pick(p[1], "n_obs", (), torch.int64) for p in parts])
    # the camera solve, replicated on every process
    dc = ba_ops.solve_cameras(S, rhs, damping)
    R_new, t_new = ba_ops.camera_updates(ba_ops.BAState(K, R, t, None), dc)
    X_new = [X + ba_ops.point_updates(b, dc.to(d)) if b is not None else X
             for (g, d, X, *_), (_, b) in zip(shards, parts)]
    return R_new, t_new, X_new, resid_sq / n_obs.clamp_min(1)


def distributed_ba_step(mesh: Mesh, state: ba_ops.BAState, obs_cam, obs_xy,
                        obs_mask, damping: float = 1e-4):
    """One joint LM step with the points sharded over the mesh (K, R, t
    replicated).  Returns (new state with the full X on the mesh's first
    device, mean squared residual at the linearization point)."""
    new_state, mses = distributed_ba(mesh, state, obs_cam, obs_xy,
                                     obs_mask, 1, damping)
    return new_state, mses[0]


def distributed_ba(mesh: Mesh, state: ba_ops.BAState, obs_cam, obs_xy,
                   obs_mask, n_steps: int = 10, damping: float = 1e-4):
    """n_steps LM steps with the points sharded over the mesh.  X stays
    in per-shard blocks on the shards' devices across the steps and is
    gathered once at the end; each shard builds K8's observation index
    once.  Returns (final state, per-step mse [n_steps], each at its
    step's linearization point)."""
    dev = mesh.device
    cams = tuple(a.to(dev) for a in (state.K, state.R, state.t))
    shards = _ba_shards(mesh, state, obs_cam, obs_xy, obs_mask)
    mses = []
    for _ in range(n_steps):
        R, t, X_blocks, mse = _ba_step(mesh, cams, shards, damping)
        cams = (cams[0], R, t)
        shards = [(g, d, X, *rest)
                  for (g, d, _, *rest), X in zip(shards, X_blocks)]
        mses.append(mse)
    X = all_gather(mesh, [s[2] for s in shards])
    new_state = ba_ops.BAState(K=cams[0], R=cams[1], t=cams[2], X=X)
    return new_state, (torch.stack(mses) if mses else
                       torch.zeros(0, dtype=X.dtype, device=dev))


# ----------------------------------------------------------------------
# sharded reconstruction sweeps
# ----------------------------------------------------------------------

def sharded_start_sweep(ctx, obs_xy, start_mask):
    """Starting intersections (K1) with the refpoint axis sharded: each
    shard runs refpoints._start_sweep on its block.  Returns (starts,
    n [size]): the shards' compacted starts in shard order, each
    shard's `ridx` local to its block."""
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    cfg = ctx.config
    parts = _run_shards([
        (g, rp._start_sweep_steps,
         (ctx.on(d), _block(obs_xy, lo, hi, d),
          _block(start_mask, lo, hi, d), cfg.detection_starting_dist_px,
          cfg.max_candidates_per_view))
        for g, d, lo, hi in ctx.mesh.local_bounds(len(obs_xy))])
    return gather_fields(ctx.mesh, parts), _counts(ctx.mesh, parts, "ridx")


def sharded_seed_from_starts(ctx, starts: dict, n_starts, obs_xy,
                             obs_mask):
    """Correspondences (K2) + 3-view seeding (K3) on each shard's starts
    (sharded_start_sweep's output) against its refpoint block.  Returns
    (seeds, n [size]): the shards' seeds in shard order, `ridx` local to
    each block (the caller adds the block offset)."""
    from edgegraph3d_tpu_torch.matching import refpoints as rp
    off = np.concatenate([[0], np.cumsum(n_starts.cpu().numpy())])
    parts = _run_shards([
        (g, rp._seed_from_starts_steps,
         (ctx.on(d), {k: v[off[g]:off[g + 1]].to(d)
                      for k, v in starts.items()},
          _block(obs_xy, lo, hi, d), _block(obs_mask, lo, hi, d),
          ctx.config.max_candidates_per_view))
        for g, d, lo, hi in ctx.mesh.local_bounds(len(obs_xy))])
    return gather_fields(ctx.mesh, parts), _counts(ctx.mesh, parts, "cams")


def _seed_blocks(ctx, seeds: following.SeedTuple):
    """(g, device, seed block, context replica, lo, hi) of each local
    shard."""
    return [(g, d, following.SeedTuple(*(a[lo:hi].to(d) for a in seeds)),
             ctx.on(d), lo, hi)
            for g, d, lo, hi in ctx.mesh.local_bounds(len(seeds.cams))]


def _gather_follow(mesh: Mesh, results) -> following.FollowResult:
    return following.FollowResult(*(
        all_gather(mesh, [r[i] for r in results])
        for i in range(len(following.FollowResult._fields))))


def sharded_follow_bidirectional(ctx, seeds: following.SeedTuple,
                                 max_steps: int):
    """Bidirectional following with the seed axis sharded, each shard
    with its own K4 walks.  Returns (fwd, bwd, total steps) over all
    seeds, in seed order."""
    out = []
    for g, d, st, rc, _, _ in _seed_blocks(ctx, seeds):
        out.append(_on_shard(
            g, following.follow_seeds_bidirectional, st, rc.plg_coords,
            rc.plg_length, rc.P_mats, rc.F_table, ctx.config, max_steps))
    fwd = _gather_follow(ctx.mesh, [o[0] for o in out])
    bwd = _gather_follow(ctx.mesh, [o[1] for o in out])
    return fwd, bwd, fwd.n_steps + bwd.n_steps


def sharded_follow_fixed(ctx, seeds: following.SeedTuple, max_steps: int,
                         perm, dirs) -> following.FollowResult:
    """Direction-pinned continuation sweep (perm / dirs [S, 3] per seed)
    with the seed axis sharded."""
    out = []
    for g, d, st, rc, lo, hi in _seed_blocks(ctx, seeds):
        out.append(_on_shard(
            g, following.follow_seeds, st, rc.plg_coords, rc.plg_length,
            rc.P_mats, rc.F_table,
            torch.ones((), dtype=torch.int32, device=d), ctx.config,
            max_steps, fixed_perm=_block(perm, lo, hi, d),
            fixed_dirs=_block(dirs, lo, hi, d)))
    return _gather_follow(ctx.mesh, out)


def sharded_expand_compact(ctx, X, obs3, cams3, chain_idx, t_idx, item_ok,
                           chain_valid, cfg, C: int, T: int,
                           extent: np.ndarray):
    """expansion.expand_chains_compact (K7) with the CHAINS sharded: shard
    g takes the contiguous block shard_bounds(C, size)[g] of the C chains
    and their points (all points of a chain on one shard; the points
    must come in chain order, chain_idx ascending).  Each shard's call
    launches its own chains as the single-device call does (one launch
    per tile bucket, longest first, expansion.launch_plan).  Arguments as
    expand_chains_compact's after its context tensors.  Returns (X',
    out_xy, out_ok) over all points, in their order."""
    from edgegraph3d_tpu_torch.matching import expansion
    mesh = ctx.mesh
    cb = shard_bounds(C, mesh.size)
    edges = torch.tensor([lo for lo, _ in cb] + [C], dtype=chain_idx.dtype,
                         device=chain_idx.device)
    ib = torch.searchsorted(chain_idx.contiguous(), edges).tolist()
    out = []
    for g, d in mesh.local_shards():
        (clo, chi), a, b = cb[g], ib[g], ib[g + 1]
        rc = ctx.on(d)
        out.append(_on_shard(
            g, expansion.expand_chains_compact, rc.plg_coords, rc.grids,
            rc.P_mats, rc.F_table, rc.cell, _block(X, a, b, d),
            _block(obs3, a, b, d), _block(cams3, clo, chi, d),
            _block(chain_idx, a, b, d) - clo, _block(t_idx, a, b, d),
            _block(item_ok, a, b, d), _block(chain_valid, clo, chi, d), cfg,
            chi - clo, T, extent=extent[clo:chi]))
    return tuple(all_gather(mesh, [o[i] for o in out]) for i in range(3))
