"""Hand-written CUDA kernels (K1-K9) against their plain-torch twins.

Runs only where a CUDA GPU and nvcc are present (marker `cuda`); the
kernels are built from edgegraph3d_tpu_torch/csrc at first use.  This
file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Both sides of every comparison run on the card on the same inputs.  The
kernels are compiled with --fmad=false and follow the twins' operation
order, so discrete decisions (polyline ids, segments, valid / alive
flags) must agree exactly and coordinates to 1e-5 px (X to 1e-4
relative).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from edgegraph3d_tpu_torch import kernels, pipeline
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import synthetic
from edgegraph3d_tpu_torch.matching import (communities, detection,
                                            expansion, following, matches,
                                            polyline_stages, refpoints)
from edgegraph3d_tpu_torch.ops import geometry, lmeds7, triangulation
from edgegraph3d_tpu_torch.ops.gather import gather_rows
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs

pytestmark = pytest.mark.cuda

CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=64, max_follow_steps=32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU to run the hand-written kernels")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    sfmd, imgs, _ = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=16, width=320, height_px=240,
        focal=400.0, seed=3)
    stack = extract_plgs(imgs, CFG)
    ctx = refpoints.build_context(sfmd, stack, CFG, device=cuda)
    return sfmd, ctx


def _assert_same_candidates(a, b):
    for f in ("pl_id", "seg", "valid"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("t", "xy", "dist"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=1e-5)


def _queries(ctx, n, seed):
    rng = np.random.default_rng(seed)
    V = ctx.grids.shape[0]
    pts = rng.uniform(-20.0, 340.0, (n, 2)).astype(np.float32)
    pts[:4] = [[0.0, 0.0], [319.9, 239.9], [-5.0, 250.0], [400.0, -30.0]]
    view = rng.integers(0, V, n).astype(np.int32)
    return (torch.as_tensor(view, device=ctx.device),
            torch.as_tensor(pts, device=ctx.device))


@pytest.mark.parametrize("Kc", [8, 6])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
def test_grid_topm_kernel_matches_plain(scene, M, Kc):
    """K1's cell-at-once body (Kc = 8) and its generic body (Kc = 6: the
    scene's grid with two slots of each cell dropped) at every M the
    kernel takes, whole-row stores (M = 1, 2, 4, 8) and scalar ones
    (M = 3), against the plain twin."""
    _, ctx = scene
    grids = ctx.grids if Kc == 8 else ctx.grids[:, :, :, :Kc].contiguous()
    view, pts = _queries(ctx, 20001, M)
    n0 = kernels.launch_totals()["grid_topm_query"]
    got = detection.grid_topm_query(grids, view, pts, ctx.cell, 10.0, M)
    assert kernels.launch_totals()["grid_topm_query"] == n0 + 1
    ref = detection._grid_topm_plain(grids, view, pts, ctx.cell, 10.0, M)
    torch.cuda.synchronize()
    assert ref.valid.any()
    if M > 1:
        assert ref.valid[:, M - 1].any()        # full rows
    _assert_same_candidates(got, ref)


@pytest.mark.parametrize("M", [1, 4, 8])
def test_grid_topm_view_cycle_order(scene, M):
    """Queries laid out as the main path lays them (view = arange(V)
    repeated over N rows), visited view by view: the plain twin's result.
    The order never changes a result: with the views shuffled under the
    same declaration the kernel still matches."""
    _, ctx = scene
    V = ctx.grids.shape[0]
    rng = np.random.default_rng(20 + M)
    N = 2501
    pts = torch.as_tensor(rng.uniform(-20.0, 340.0, (N * V, 2))
                          .astype(np.float32), device=ctx.device)
    cyc = torch.arange(V, dtype=torch.int32, device=ctx.device).repeat(N)
    shuffled = torch.as_tensor(rng.integers(0, V, N * V).astype(np.int32),
                               device=ctx.device)
    for view in (cyc, shuffled):
        got = detection.grid_topm_query(ctx.grids, view, pts, ctx.cell,
                                        10.0, M, view_cycle=True)
        ref = detection._grid_topm_plain(ctx.grids, view, pts, ctx.cell,
                                         10.0, M)
        torch.cuda.synchronize()
        assert ref.valid.any()
        _assert_same_candidates(got, ref)


def test_grid_topm_misaligned_grid_raises(scene):
    """The cell-at-once body loads 16 bytes at a time: a grid stack that
    is 8- but not 16-byte aligned raises before the launch."""
    _, ctx = scene
    n = ctx.grids.numel()
    buf = torch.empty(n + 2, dtype=torch.float32, device=ctx.device)
    grids = buf[2:].view(ctx.grids.shape)
    grids.copy_(ctx.grids)
    assert grids.data_ptr() % 16 == 8
    view, pts = _queries(ctx, 100, 0)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        detection.grid_topm_query(grids, view, pts, ctx.cell, 10.0, 4)


@pytest.mark.parametrize("exclude", [None, 0.965])
def test_epipolar_topm_kernel_matches_plain(scene, exclude):
    _, ctx = scene
    view, pts = _queries(ctx, 20000, 7)
    rng = np.random.default_rng(8)
    p = pts.cpu().numpy()
    ang = rng.uniform(0, np.pi, len(p))
    ab = np.stack([np.cos(ang), np.sin(ang)], 1)
    c = -(ab * p).sum(1) + rng.normal(0, 5.0, len(p))
    lines = torch.as_tensor(np.concatenate([ab, c[:, None]], 1)
                            .astype(np.float32), device=ctx.device)
    radius = torch.as_tensor(rng.uniform(3.0, 30.0, len(p))
                             .astype(np.float32), device=ctx.device)
    got = detection.epipolar_topm_query(ctx.grids, view, pts, lines, radius,
                                        ctx.cell, 4, exclude)
    ref = detection._epipolar_topm_plain(ctx.grids, view, pts, lines,
                                         radius, ctx.cell, 4, exclude)
    torch.cuda.synchronize()
    assert ref.valid.any()
    _assert_same_candidates(got, ref)
    # the seeding's layout, visited view-major (long runs of one
    # neighbourhood), and the same queries shuffled (the sorted plan)
    a = _k2_seeding_queries(rng, ctx.grids, ctx.cell, torch.float32)
    ref = detection._epipolar_topm_plain(*a, ctx.cell, 4, exclude)
    perm = torch.as_tensor(rng.permutation(len(a[1])), device=ctx.device)
    got = detection.epipolar_topm_query(*a, ctx.cell, 4, exclude,
                                        view_cycle=True)
    got_s = detection.epipolar_topm_query(
        ctx.grids, *(t[perm] for t in a[1:]), ctx.cell, 4, exclude)
    torch.cuda.synchronize()
    assert ref.valid.any()
    _assert_same_candidates(got, ref)
    _assert_same_candidates(got_s, detection.Candidates(*(t[perm]
                                                          for t in ref)))


def _gn_problem(sfmd, P, N, O, rng, mask_p=0.85):
    """N points of the scene seen by O random cameras of P [V, 3, 4]
    (numpy), with 1.5 px noise, a fifth gross outliers and random
    (non-prefix) masks."""
    V = len(P)
    X = sfmd.points[rng.integers(0, sfmd.n_points, N)] \
        + rng.normal(0, 0.01, (N, 3))
    cams = np.stack([rng.permutation(V)[:O] for _ in range(N)]) \
        .astype(np.int32)
    Xh = np.concatenate([X, np.ones((N, 1))], 1)
    proj = np.einsum("noij,nj->noi", P[cams], Xh)
    xy = proj[..., :2] / proj[..., 2:3] + rng.normal(0, 1.5, (N, O, 2))
    xy[rng.random(N) < 0.2, 0] += 25.0          # gross outliers: rejects
    mask = rng.random((N, O)) < mask_p
    return X, cams, xy.astype(np.float32), mask


@pytest.mark.parametrize("O,warm,case", [
    (2, False, "random"), (3, False, "random"), (3, True, "random"),
    (3, False, "masked"), (3, False, "many rows"), (3, True, "many rows"),
    (8, True, "random"), (8, False, "random"), (8, False, "inf masked"),
    (8, True, "inf masked")])
def test_triangulate_gn_kernel_matches_plain(scene, O, warm, case):
    """K3's O = 3 register body (with masked observations at 30% in
    "masked"; with 200,003 rows in "many rows", a count that is no
    multiple of the block) and its
    general body, which walks only the present observations of random
    non-prefix masks, against the padded plain twin.  "inf masked" puts
    inf at every masked observation, so the padded sums turn NaN
    (0 * inf): the general body must redo such rows padded and give the
    plain twin's NaN mse and decisions."""
    sfmd, ctx = scene
    rng = np.random.default_rng(O + 10 * warm + 100 * len(case))
    N = 200003 if case == "many rows" else 8192
    X, cams, xy, mask = _gn_problem(sfmd, sfmd.P, N, O, rng,
                                    0.7 if case == "masked" else 0.85)
    if case == "inf masked":
        xy[~mask] = np.inf
    dev = ctx.device
    args = (ctx.P_mats, torch.as_tensor(cams, device=dev),
            torch.as_tensor(xy, device=dev), torch.as_tensor(mask, device=dev))
    X0 = (torch.as_tensor((X + rng.normal(0, 0.02, X.shape))
                          .astype(np.float32), device=dev) if warm else None)
    kw = dict(X0=X0, max_iters=8 if warm else 30, accept_mse=9.0)
    n0 = kernels.launch_totals()["triangulate_gn"]
    Xk, msek, okk = triangulation.triangulate_gn(*args, **kw)
    assert kernels.launch_totals()["triangulate_gn"] == n0 + 1
    Xp, msep, okp = triangulation._triangulate_gn_plain(
        *args, X0, kw["max_iters"], 5e-7, 9.0, 1e-5)
    torch.cuda.synchronize()
    assert okp.any() and not okp.all()
    assert torch.equal(okk, okp)
    assert torch.equal(msek.isnan(), msep.isnan())
    if case == "inf masked":
        assert msep.isnan().any()
    torch.testing.assert_close(Xk[okp], Xp[okp], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(msek[okp], msep[okp], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("V_big,where", [(1100, "optin"),
                                         (5000, "global")])
def test_triangulate_gn_kernel_large_camera_table(scene, V_big, where):
    """A camera table beyond 48 KiB: the general body opts in to more
    shared memory (1,100 cameras) or reads the table from device memory
    (5,000 cameras, beyond the card's opt-in limit), and matches the
    plain twin either way, as does the O = 3 body (no table staged)."""
    sfmd, ctx = scene
    rng = np.random.default_rng(4)
    V = ctx.P_mats.shape[0]
    reps = -(-V_big // V)
    P_big = np.tile(sfmd.P, (reps, 1, 1))[:V_big]
    dev = ctx.device
    P_t = torch.as_tensor(P_big.astype(np.float32), device=dev)
    n_bytes = triangulation.gn_table_bytes(V_big)
    assert kernels.lib().eg3d_triangulate_gn_smem(V_big, 4) == n_bytes
    assert kernels.table_placement(
        n_bytes, kernels.smem_optin_bytes(dev)) == where
    for O in (3, 4):
        _, cams, xy, mask = _gn_problem(sfmd, sfmd.P, 4096, O, rng)
        cams = cams + V * rng.integers(0, V_big // V, cams.shape,
                                       dtype=np.int32)
        if O == 4:
            xy[:64][~mask[:64]] = np.inf        # rows redone padded
        args = (P_t, torch.as_tensor(cams, device=dev),
                torch.as_tensor(xy, device=dev),
                torch.as_tensor(mask, device=dev))
        Xk, msek, okk = triangulation.triangulate_gn(*args)
        if O == 4:
            assert kernels.LAST_PLACEMENT["triangulate_gn"] == where
        Xp, msep, okp = triangulation._triangulate_gn_plain(
            *args, None, 30, 5e-7, 9.0, 1e-5)
        torch.cuda.synchronize()
        assert okp.any() and torch.equal(okk, okp)
        assert torch.equal(msek.isnan(), msep.isnan())
        torch.testing.assert_close(Xk[okp], Xp[okp], rtol=1e-4, atol=1e-6)


def _plain_follow(args, T, cfg):
    """K4's plain twin on the same (card) tensors as the kernel."""
    walk, gn = following.follow_params(cfg, args[-1] is not None)
    return following._follow_plain(*args, T, *walk, *gn)


def _assert_same_follow(got, ref):
    """K4 against its plain twin: every decision equal, every slot
    (zeros beyond the cut) within 1e-5 px, X within 1e-4 relative."""
    for f in ("valid", "n_steps", "seg", "final_seg"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("obs", "t", "final_t"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=1e-5, msg=f)
    torch.testing.assert_close(got.X, ref.X, rtol=1e-4, atol=1e-6)


def _scene_seeds(sfmd, ctx):
    obs_xy, obs_mask = refpoints.dense_observations(sfmd)
    dev = ctx.device
    seeds = refpoints.compute_seeds_chunk(
        ctx, torch.as_tensor(obs_xy, device=dev),
        torch.as_tensor(obs_mask, device=dev),
        torch.as_tensor(obs_mask, device=dev))
    assert len(seeds["cams"]) > 0
    return seeds


def _follow_args(ctx, seeds, rows, dirs, active, warm):
    """follow_walk's positional arguments up to X0 for the seeds `rows`."""
    pick = lambda k, dt=None: (seeds[k][rows] if dt is None
                               else seeds[k][rows].to(dt))
    i32 = torch.int32
    return (ctx.plg_coords, ctx.plg_length, ctx.F_table, ctx.P_mats,
            pick("cams", i32), pick("pl_id", i32), pick("seg", i32),
            pick("t"), pick("xy"), dirs, active,
            pick("X") if warm else None)


@pytest.mark.parametrize("warm,T,accept", [(False, 32, 9.0), (False, 8, 0.2),
                                           (True, 1, 9.0), (True, 4, 0.2)])
def test_follow_walk_kernel_matches_plain(scene, warm, T, accept):
    """The fused K4 (walk plus the GN acceptance of every step, cold: DLT
    and 30 iterations; warm: 8 iterations from the seed's X) against its
    plain twin (the walk, the GN over its live steps, the prefix cut).
    The tight MSE gate (0.2) cuts chains at a GN failure."""
    sfmd, ctx = scene
    cfg = ctx.config.replace(match_gn_max_mse=accept)
    seeds = _scene_seeds(sfmd, ctx)
    S = len(seeds["cams"])
    dev = ctx.device
    rng = np.random.default_rng(T)
    dirs = torch.as_tensor(rng.choice([-1, 1], (S, 3)).astype(np.int32),
                           device=dev)
    args = _follow_args(ctx, seeds, torch.arange(S, device=dev), dirs,
                        torch.ones(S, dtype=torch.bool, device=dev), warm)
    n0 = kernels.launch_totals()["follow_walk"]
    got = following.follow_walk(*args, T, cfg)
    assert kernels.launch_totals()["follow_walk"] == n0 + 1
    ref = _plain_follow(args, T, cfg)
    torch.cuda.synchronize()
    assert ref.valid[:, 0].any()
    if accept < 1.0:                           # chains ended by the GN
        at = ref.n_steps.clamp(max=T - 1).long()
        assert ((ref.n_steps < T)
                & (ref.obs[torch.arange(S), at] != 0).flatten(1).any(1)).any()
    _assert_same_follow(got, ref)


def test_follow_walk_kernel_refills_lanes(scene):
    """Lane refill at its edges: a lane count that is no multiple of the
    block (128), lanes dead at step 0 mixed with lanes that stay alive
    for all T steps, then every lane dead at step 0, then every lane
    alive for T steps: each seed's slots as its plain twin's."""
    sfmd, ctx = scene
    seeds = _scene_seeds(sfmd, ctx)
    S = len(seeds["cams"])
    dev = ctx.device
    T = 4
    ones = torch.ones(S, dtype=torch.bool, device=dev)
    dirs = torch.ones((S, 3), dtype=torch.int32, device=dev)
    full = following.follow_walk(*_follow_args(
        ctx, seeds, torch.arange(S, device=dev), dirs, ones, False), T,
        ctx.config)
    long_ = torch.nonzero(full.n_steps == T).flatten()
    assert len(long_) > 0
    rng = np.random.default_rng(1)
    n = 3001
    for case in ("mixed", "all dead", "all alive"):
        if case == "all alive":
            rows = long_[torch.as_tensor(rng.integers(0, len(long_), n),
                                         device=dev)]
        else:
            rows = torch.as_tensor(rng.integers(0, S, n), device=dev)
        active = (torch.as_tensor(rng.random(n) < 0.5, device=dev)
                  if case == "mixed" else
                  torch.full((n,), case == "all alive", device=dev))
        args = _follow_args(ctx, seeds, rows, dirs[rows], active, False)
        got = following.follow_walk(*args, T, ctx.config)
        ref = _plain_follow(args, T, ctx.config)
        torch.cuda.synchronize()
        _assert_same_follow(got, ref)
        if case == "all dead":
            assert not got.valid.any()
        if case == "all alive":
            assert bool((got.n_steps == T).all())


def _walk_with_negative_ids(ctx):
    """follow_walk arguments where a third of the lanes carry pl = -1 and
    seg = -1, every lane active, half of them driven from view 0.  Each
    view's last polyline slot holds a copy of its longest polyline, so
    the lanes with pl = -1 walk."""
    coords, lengths, dev = ctx.plg_coords, ctx.plg_length, ctx.device
    V, P, L, _ = coords.shape
    rng = np.random.default_rng(5)
    longest = lengths.argmax(1)
    coords = coords.clone()
    lengths = lengths.clone()
    coords[:, P - 1] = coords[torch.arange(V), longest]
    lengths[:, P - 1] = lengths[torch.arange(V), longest]
    S = 3000
    cams = np.stack([rng.permutation(V)[:3] for _ in range(S)]) \
        .astype(np.int32)
    cams[::2, 0] = 0
    cams[::2, 1:] = (cams[::2, 1:] % (V - 1)) + 1
    lon = longest.cpu().numpy()
    pl = lon[cams].astype(np.int32)
    seg = np.zeros((S, 3), np.int32)
    bad = rng.random(S) < 1 / 3
    pl[bad], seg[bad] = -1, -1
    c = coords.cpu().numpy()
    xy = c[cams, np.where(pl < 0, P - 1, pl), 0]
    t = rng.uniform(0, 0.2, (S, 3)).astype(np.float32)
    dirs = rng.choice([-1, 1], (S, 3)).astype(np.int32)
    dirs[:, 0] = 1
    as_t = lambda a: torch.as_tensor(a, device=dev)
    return bad, (coords, lengths, ctx.F_table, ctx.P_mats, as_t(cams),
                 as_t(pl), as_t(seg), as_t(t), as_t(xy.astype(np.float32)),
                 as_t(dirs), torch.ones(S, dtype=torch.bool, device=dev),
                 None)


def test_follow_walk_kernel_wraps_negative_ids(scene):
    """Lanes of invalid seeds (pl = -1, seg = -1, as chain extension
    hands them to resolve_configuration's all-active trial step) read the
    view's last polyline, as the twin's torch index does, and never read
    outside the table."""
    _, ctx = scene
    bad, args = _walk_with_negative_ids(ctx)
    got = following.follow_walk(*args, 4, ctx.config)
    ref = _plain_follow(args, 4, ctx.config)
    torch.cuda.synchronize()
    assert ref.valid[torch.as_tensor(bad, device=ctx.device), 0].any()
    _assert_same_follow(got, ref)


def test_stage3_on_gpu_matches_cpu(scene):
    """The whole stage-3 slice on the card (kernels) against the same
    code on the CPU (plain twins): same points, same view sets."""
    sfmd, ctx = scene
    cpu_ctx = refpoints.MatchingContext(
        *(t.cpu() for t in (ctx.plg_coords, ctx.plg_length, ctx.grids,
                            ctx.P_mats, ctx.F_table)),
        cell=ctx.cell, config=ctx.config, device=torch.device("cpu"))
    kernels.reset_launch_counts()
    gpu = refpoints.reconstruct_from_refpoints(sfmd, ctx,
                                               max_starting_views=2)
    stage3 = ("grid_topm_query", "epipolar_topm_query", "triangulate_gn",
              "follow_walk", "gather_rows")
    totals = kernels.launch_totals()
    assert all(totals[k] > 0 for k in stage3), totals
    cpu = refpoints.reconstruct_from_refpoints(sfmd, cpu_ctx,
                                               max_starting_views=2)
    assert len(gpu.X) == len(cpu.X) > 0
    np.testing.assert_array_equal(gpu.obs_mask, cpu.obs_mask)
    np.testing.assert_allclose(gpu.X, cpu.X, rtol=0, atol=1e-4)


def _cpu_ctx(ctx):
    return refpoints.MatchingContext(
        *(t.cpu() for t in (ctx.plg_coords, ctx.plg_length, ctx.grids,
                            ctx.P_mats, ctx.F_table)),
        cell=ctx.cell, config=ctx.config, device=torch.device("cpu"))


#: K5 cases (R, W, S, offset in elements, every index the same): the
#: 16-byte bodies of 8, 16 (two rows a warp) and 32 pieces and the
#: general one, the scalar body (odd W, or a view 4, 8 or 12 bytes off
#: 16-byte alignment), S not a multiple of a tile, S past the grid (the
#: grid-stride loop) and one row copied S times
K5_CASES = [(65536, 128, 16384, 0, False), (4096, 128, 9999, 1, False),
            (1000, 7, 3000, 0, False), (4096, 64, 9999, 0, False),
            (4096, 32, 9999, 0, False), (4096, 4, 9999, 0, False),
            (4096, 1, 9999, 0, False), (4096, 66, 9999, 0, False),
            (4096, 130, 9999, 0, False), (4096, 64, 2**20 + 3, 0, False),
            (4096, 64, 9999, 0, True), (4096, 64, 9999, 1, False),
            (4096, 64, 9999, 2, False), (4096, 64, 9999, 3, False)]


def _k5_inputs(cuda, R, W, S, offset, same, dtype, index_dtype):
    g = torch.Generator(device=cuda).manual_seed(R + W + S + offset)
    base = torch.randn(R * W + offset, generator=g, device=cuda,
                       dtype=dtype)
    table = base[offset:].view(R, W)
    rows = torch.full((S,), R // 2, device=cuda) if same else \
        torch.randint(0, R, (S,), generator=g, device=cuda)
    return table, rows.to(index_dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("R,W,S,offset,same", K5_CASES)
def test_gather_rows_kernel_matches_plain(cuda, R, W, S, offset, same,
                                          dtype):
    """Bit-equal to table[rows] in every body of K5 (K5_CASES), with
    int32 and int64 indices."""
    table, rows = _k5_inputs(cuda, R, W, S, offset, same, torch.float32,
                             dtype)
    n0 = kernels.launch_totals()["gather_rows"]
    got = gather_rows(table, rows)
    assert kernels.launch_totals()["gather_rows"] == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, table[rows.long()])


_OUT_OF_RANGE = textwrap.dedent("""
    import sys
    import torch
    from edgegraph3d_tpu_torch.ops.gather import gather_rows
    table = torch.zeros({shape}, device="cuda", dtype=torch.{table})
    gather_rows(table, torch.tensor({bad}, device="cuda",
                                    dtype=torch.{dtype}))
    try:
        torch.cuda.synchronize()
    except Exception as e:            # torch.AcceleratorError on 2.8+
        print("RAISED", e)
        sys.exit(3)
    print("NO ERROR")
""")


@pytest.mark.parametrize("bad,dtype,table,shape", [
    ([0, 10], "int64", "float32", (10, 8)),
    ([-1, 3], "int32", "float32", (10, 8)),
    ("[0] * 3000 + [10]", "int64", "float32", (10, 64)),
    ("[3] * 40 + [-2]", "int32", "float64", (10, 7))])
def test_gather_rows_out_of_range_raises(cuda, bad, dtype, table, shape):
    """An index outside [0, R) fails the kernel's device-side assert, as
    table[rows] does on the card, reported at the next synchronise: in
    the first tile and in a later one, in the 16-byte and the scalar
    bodies, f32 and f64.  It runs in a child process: the assert
    poisons the CUDA context of the process it fires in."""
    kernels.lib()                           # build before the child runs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _OUT_OF_RANGE.format(
            bad=bad, dtype=dtype, table=table, shape=shape)],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert res.returncode == 3, (res.stdout, res.stderr[-2000:])
    assert "device-side assert" in res.stdout


@pytest.fixture(scope="module")
def groups(scene):
    sfmd, ctx = scene
    cpu = _cpu_ctx(ctx)
    g = polyline_stages.similarity_match_sets(sfmd, cpu) \
        + polyline_stages.closeness_match_sets(sfmd, cpu)
    assert len(g) > 0
    return g


def test_group_seed_sample_kernel_matches_plain(scene, groups):
    """K6 on the card against its plain twin on the card, every output
    slot (crossings and the first-non-crossing fill slots); both compute
    the epipolar lines in the FMA form (geometry.epipolar_line_fma)."""
    _, ctx = scene
    cam, pl, msk = (torch.as_tensor(a, device=ctx.device) for a in
                    polyline_stages._member_table(groups, 8))
    V, P, L, _ = ctx.plg_coords.shape
    cs, ps = cam.clamp_min(0).long(), pl.clamp_min(0).long()
    coords = gather_rows(ctx.plg_coords.reshape(V * P, 2 * L),
                         (cs * P + ps).reshape(-1)).reshape(*cam.shape, L, 2)
    lengths = torch.where(msk, ctx.plg_length[cs, ps], 0).to(torch.int32)
    args = (coords, lengths, cam, msk, ctx.F_table, 24, 20.0, 0.965, 5.0)
    n0 = kernels.launch_totals()["group_seed_sample"]
    got = polyline_stages.group_seed_sample(*args)
    assert kernels.launch_totals()["group_seed_sample"] == n0 + 1
    ref = polyline_stages._group_seed_sample_plain(*args)
    torch.cuda.synchronize()
    assert ref[3].any() and ref[7].any()
    for i in (1, 3, 5, 7):                  # s_seg, s_valid, i_seg, i_ok
        assert torch.equal(got[i], ref[i]), i
    for i in (0, 2, 4, 6):                  # s_xy, s_t, i_xy, i_t
        torch.testing.assert_close(got[i], ref[i], rtol=1e-6, atol=1e-5,
                                   equal_nan=True)


@pytest.mark.parametrize("K,S,where", [(128, 24, "optin"),
                                       (460, 4, "global")])
def test_group_seed_sample_kernel_large_groups(scene, K, S, where):
    """One group whose member table exceeds 48 KiB (128 members of 64
    points: opted-in shared memory) and one whose polylines alone exceed
    the card's opt-in limit (460 members: read from device memory), drawn
    at random from the scene's polylines, against the plain twin."""
    _, ctx = scene
    dev = ctx.device
    L = 64                            # the scene's polylines padded to 64
    n_bytes = polyline_stages.k6_table_bytes(K, L)
    assert kernels.lib().eg3d_group_seed_sample_smem(K, L, S) == n_bytes
    assert kernels.table_placement(
        n_bytes, kernels.smem_optin_bytes(dev)) == where
    live = torch.nonzero(ctx.plg_length >= 2)
    gen = torch.Generator(device=dev).manual_seed(K)
    pick = live[torch.randint(0, len(live), (1, K), generator=gen,
                              device=dev)]
    cam = pick[..., 0].to(torch.int32)
    pl = pick[..., 1]
    msk = torch.rand((1, K), generator=gen, device=dev) < 0.9
    coords = torch.nn.functional.pad(
        ctx.plg_coords[cam.long(), pl],
        (0, 0, 0, L - ctx.plg_coords.shape[2])).contiguous()
    lengths = torch.where(msk, ctx.plg_length[cam.long(), pl], 0) \
        .to(torch.int32)
    args = (coords, lengths, cam, msk, ctx.F_table, S, 20.0, 0.965, 5.0)
    got = polyline_stages.group_seed_sample(*args)
    assert kernels.LAST_PLACEMENT["group_seed_sample"] == where
    ref = polyline_stages._group_seed_sample_plain(*args)
    torch.cuda.synchronize()
    assert ref[7].any()
    for i in (1, 3, 5, 7):
        assert torch.equal(got[i], ref[i]), i
    for i in (0, 2, 4, 6):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-6, atol=1e-5,
                                   equal_nan=True)


@pytest.fixture(scope="module")
def chains(scene):
    """The scene's swept stage-3 chains (CPU context), one chunk in the
    layout expand_and_assemble hands to expand_chains_compact: (C, T,
    each chain's slot extent, tensors)."""
    sfmd, ctx = scene
    cpu = _cpu_ctx(ctx)
    mgr = matches.MatchesManager(cpu.plg_length.numpy())
    round0, _ = refpoints.compute_and_follow_seeds(sfmd, cpu,
                                                   max_starting_views=2)
    X, obs3, cams3, _, seed_ids, orders = refpoints.sweep_seeds(
        None, None, cpu, mgr, precomputed=round0)
    T = 64
    gather, vld = expansion.group_chains(seed_ids, orders, max_t=T)
    kidx = np.flatnonzero(vld.reshape(-1))
    rows = gather.reshape(-1)[kidx]
    dev = ctx.device
    as_t = lambda a: torch.as_tensor(a, device=dev)
    return len(gather), T, vld.sum(1), (
        as_t(np.asarray(X, np.float32)[rows]),
        as_t(np.asarray(obs3, np.float32)[rows]),
        as_t(cams3[gather[:, 0]].astype(np.int32)),
        as_t(kidx // T), as_t(kidx % T),
        torch.ones(len(kidx), dtype=torch.bool, device=dev), as_t(vld))


def _k7_launches(extent):
    return len(expansion.launch_plan(extent).launches)


def _assert_same_expansion(got, ref, dtype):
    """0 decision mismatches; f32 bit-equal, f64 within F64_TOL."""
    assert torch.equal(got[2], ref[2])
    if dtype == torch.float32:
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    else:
        assert got[0].dtype == got[1].dtype == torch.float64
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_expand_chains_kernel_matches_plain(scene, chains, mode):
    """K7 (one launch per tile bucket) against its plain version (the
    view loop around K1 / K2 / K3) on the card: the same
    acceptances, out_xy and X bit-equal or within 1e-6 relative."""
    _, ctx = scene
    C, T, extent, tensors = chains
    cfg = ctx.config.replace(expand_correspondence_mode=mode)
    args = (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            *tensors, cfg, C, T)
    n0 = kernels.launch_totals()["expand_chains"]
    Xk, xyk, okk = expansion.expand_chains_compact(*args, extent)
    assert kernels.launch_totals()["expand_chains"] == \
        n0 + _k7_launches(extent)
    Xp, xyp, okp = expansion._expand_chains_compact_plain(*args)
    torch.cuda.synchronize()
    assert okp.sum(1).max() > 3                 # views were added
    assert torch.equal(okk, okp)
    torch.testing.assert_close(xyk, xyp, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(Xk, Xp, rtol=1e-6, atol=1e-6)


def _tiled(t, V_big, dims):
    idx = torch.arange(V_big, device=t.device) % t.shape[dims[0]]
    for d in dims:
        t = t.index_select(d, idx)
    return t.contiguous()


@pytest.mark.parametrize("mode,V_big", [("epipolar", 400),
                                        ("closest", 5000)])
def test_expand_chains_large_camera_table(scene, chains, mode, V_big):
    """K7 with its camera tables beyond the card's opt-in shared memory
    (the scene's P, F and grids tiled to V_big views): the body that reads
    P and the F rows from device memory, bit-equal to the plain version."""
    _, ctx = scene
    C, T, extent, tensors = chains
    n_bytes = expansion.k7_table_bytes(V_big, mode == "epipolar")
    assert kernels.table_placement(
        n_bytes, kernels.smem_optin_bytes(ctx.device)) == "global"
    cfg = ctx.config.replace(expand_correspondence_mode=mode)
    args = (ctx.plg_coords, _tiled(ctx.grids, V_big, [0]),
            _tiled(ctx.P_mats, V_big, [0]),
            _tiled(ctx.F_table, V_big, [0, 1]), ctx.cell, *tensors, cfg, C,
            T)
    got = expansion.expand_chains_compact(*args, extent)
    assert kernels.LAST_PLACEMENT["expand_chains"] == "global"
    ref = expansion._expand_chains_compact_plain(*args)
    torch.cuda.synchronize()
    assert ref[2].sum(1).max() > 3                 # views were added
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


LENGTHS = (1, 2, 3, 8, 9, 16, 17, 32, 33, 40, 48, 63, 64)


def _regrouped(chains):
    """The fixture's chain points, in chain order and cycled as often as
    needed, cut into new chains of every tile bucket's edge lengths and
    some 33-64-slot ones (LENGTHS); each new chain takes the tuple views
    of its first point's chain."""
    C, T, _, (X, obs3, cams3, ci, ti, ok, vld) = chains
    order = torch.argsort(ci * T + ti)
    lens = list(LENGTHS)
    K = sum(lens)
    rows = order[torch.arange(K, device=order.device) % len(order)]
    new_c = np.repeat(np.arange(len(lens)), lens)
    new_t = np.concatenate([np.arange(n) for n in lens])
    first = rows[torch.as_tensor(np.cumsum([0] + lens[:-1]),
                                 device=rows.device)]
    dev = X.device
    valid = torch.zeros((len(lens), T), dtype=torch.bool, device=dev)
    valid[torch.as_tensor(new_c, device=dev),
          torch.as_tensor(new_t, device=dev)] = True
    return len(lens), T, np.asarray(lens), (
        X[rows], obs3[rows], cams3[ci[first]],
        torch.as_tensor(new_c, device=dev), torch.as_tensor(new_t, device=dev),
        ok[rows], valid)


@pytest.mark.parametrize("place", ["shared", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_expand_chains_every_tile_width(scene, scene64, chains, mode, dtype,
                                        place):
    """Chains of 1, 2, 3, 8, 9, 16, 17, 32, 33, 40, 48, 63 and 64 points
    in one call (every tile bucket, each at its edges; 33-64 slots on the
    two-warp tile): K7 (one launch a bucket), in f32 and f64, with its tables
    in shared memory and (cameras tiled past the opt-in limit) in device
    memory, against its plain version: f32 bit-equal, f64 within 1e-9."""
    _, ctx = scene64 if dtype == torch.float64 else scene
    C, T, lens, tensors = _regrouped(chains)
    cfg = ctx.config.replace(expand_correspondence_mode=mode)
    P, F, grids = ctx.P_mats, ctx.F_table, ctx.grids
    if place == "global":       # just past the opt-in limit
        V_big = {"epipolar": 400, "closest": 2500 if dtype == torch.float64
                 else 5000}[mode]
        P, F, grids = (_tiled(P, V_big, [0]), _tiled(F, V_big, [0, 1]),
                       _tiled(grids, V_big, [0]))
    args = (ctx.plg_coords, grids, P, F, ctx.cell, *tensors, cfg, C, T)
    ref = expansion._expand_chains_compact_plain(*args)
    n0 = kernels.LAUNCHES["expand_chains"][str(dtype)[6:]]
    got = expansion.expand_chains_compact(*args, lens)
    assert kernels.LAUNCHES["expand_chains"][str(dtype)[6:]] == \
        n0 + _k7_launches(lens)
    assert kernels.LAST_PLACEMENT["expand_chains"] == (
        "global" if place == "global" else "static")
    torch.cuda.synchronize()
    assert ref[2].sum(1).max() > 3                 # views were added
    long_rows = np.flatnonzero(np.repeat(lens > 32, lens))
    assert int(ref[2][long_rows].sum()) > 3 * len(long_rows)
    _assert_same_expansion(got, ref, dtype)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_expand_chains_smem_bytes(cuda, dtype, pairs):
    """k7_table_bytes, by which the wrapper places K7's tables, is the
    shared memory the kernel's launch asks for (with the pairs' exchange
    in the bodies that run 64-slot tiles)."""
    entry = kernels.lib().eg3d_expand_chains_smem if dtype == torch.float32 \
        else kernels.lib().eg3d_expand_chains_smem_f64
    for V in (1, 49, 372, 4842):
        for epi in (False, True):
            assert entry(V, int(epi), int(pairs)) == \
                expansion.k7_table_bytes(V, epi, dtype, pairs)


#: K2's bodies by the C entry's `body`: the shared-neighbourhood body
#: (the wrapper's) and one thread a query (K7's)
K2_BODIES = {"shared": 0, "one thread": 1}


def _k2_launch(args, body, view_cycle=False, exclude=None,
               min_share=detection.K2_MIN_SHARE,
               tile_rows=detection.K2_TILE_ROWS):
    """K2's C entry with `body` on the wrapper's plan (detection.k2_plan;
    view-major tiles of `tile_rows` rows with `view_cycle`), into fresh
    outputs, as the wrapper launches its own body."""
    grids, view, pts, lines, radius, cell, M = (
        t.contiguous() if torch.is_tensor(t) else t for t in args)
    V, GH, GW, Kc, _ = grids.shape
    Q = len(view)
    dt = lines.dtype
    radius = radius.to(dt)
    out = detection._empty_outputs(Q, M, pts.device, dt)
    order, n_rows = detection.k2_plan(grids, view, pts, cell, view_cycle)
    use = exclude is not None
    lib = kernels.lib()
    entry, pts_arg = (lib.eg3d_epipolar_topm, (pts.data_ptr(),)) \
        if dt == torch.float32 else (lib.eg3d_epipolar_topm_f64, (
            pts.data_ptr(), int(pts.dtype == torch.float64)))
    rc = entry(grids.data_ptr(), V, GH, GW, Kc, view.data_ptr(), *pts_arg,
               lines.data_ptr(), radius.data_ptr(), kernels.ptr(order),
               n_rows, tile_rows, Q, float(cell), M, K2_BODIES[body],
               min_share,
               int(use), float(exclude) if use else 0.0,
               *detection._out_ptrs(out), kernels.stream_of(pts))
    kernels.check(rc, "epipolar_topm_query")
    return out


def _k2_one_thread(grids, view, pts, lines, radius, cell, M,
                   exclude_parallel_cos=None):
    """K2's one-thread-per-query body (the one K7's "epipolar" mode runs)
    in place of the wrapper, with the wrapper's signature."""
    return _k2_launch((grids, view, pts, lines, radius, cell, M),
                      "one thread", exclude=exclude_parallel_cos)


def _k2_seeding_queries(rng, grids, cell, dtype, pts_dtype=torch.float32):
    """Queries laid out as the seeding lays them (view, pts, lines,
    radius): starts of refpoints x every view, start-major, every start of
    a refpoint carrying the refpoint's point on each view.  Refpoints with
    1 start (one-query runs) up to 150 (runs longer than several warps'
    tasks); points at the image border, beyond it and at (0, 0) (a view
    that does not observe the refpoint)."""
    V, GH, GW = grids.shape[:3]
    W, H = GW * cell, GH * cell
    n = np.array([1, 1, 2, 31, 33, 1, 64, 129, 150, 5, 1, 40, 3, 97])
    R, K = len(n), int(n.sum())
    rp = np.stack([rng.uniform(-8, W + 8, (R, V)),
                   rng.uniform(-8, H + 8, (R, V))], -1)
    rp[0, :3] = [[0, 0], [W - 0.1, H - 0.1], [-4, H / 2]]
    rp[rng.random((R, V)) < 0.2] = 0.0
    ridx = np.repeat(np.arange(R), n)
    pts = rp[ridx].reshape(K * V, 2)
    ang = rng.uniform(0, np.pi, K * V)
    ab = np.stack([np.cos(ang), np.sin(ang)], 1)
    c = -(ab * pts).sum(1) + rng.normal(0, 4.0, K * V)
    lines = np.concatenate([ab, c[:, None]], 1)
    radius = np.repeat(rng.uniform(3.0, 30.0, K), V)
    dev = grids.device
    return (grids,
            torch.arange(V, dtype=torch.int32, device=dev).repeat(K),
            torch.as_tensor(pts, dtype=pts_dtype, device=dev),
            torch.as_tensor(lines, dtype=dtype, device=dev),
            torch.as_tensor(radius, dtype=torch.float32, device=dev))


def test_expand_chains_epipolar_under_both_k2_bodies(scene, chains,
                                                     monkeypatch):
    """K7's "epipolar" mode runs K2's one-thread body per point; its
    plain version calls the K2 wrapper.  K7 equals the plain version with
    K2 in its shared-neighbourhood body (the wrapper) and in its
    one-thread body."""
    _, ctx = scene
    C, T, extent, tensors = chains
    cfg = ctx.config.replace(expand_correspondence_mode="epipolar")
    args = (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            *tensors, cfg, C, T)
    got = expansion.expand_chains_compact(*args, extent)
    for body in ("shared", "one thread"):
        if body == "one thread":
            monkeypatch.setattr(expansion, "epipolar_topm_query",
                                _k2_one_thread)
        ref = expansion._expand_chains_compact_plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b), body


def _tie_grid(rng, V, GH, GW, Kc=8):
    """A grid stack with lattice endpoints, repeated polyline ids, empty
    slots and duplicated entries: many equal distances."""
    n = V * GH * GW * Kc
    e = np.full((n, 6), -1.0, np.float32)
    e[:, 0] = rng.integers(0, 12, n)
    e[:, 1] = rng.integers(0, 4, n)
    cy, cx = np.divmod((np.arange(n) // Kc) % (GH * GW), GW)
    for c, base in ((2, cx), (3, cy), (4, cx), (5, cy)):
        e[:, c] = base * 10 + rng.integers(-6, 16, n)
    dup = rng.random(n) < 0.3
    e[dup] = e[rng.integers(0, n, dup.sum())]
    e[rng.random(n) < 0.2, 0] = -1
    return e.reshape(V, GH, GW, Kc, 6)


@pytest.mark.parametrize("exclude", [None, 0.965])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_epipolar_topm_bodies_and_orders(scene, M, ties, exclude):
    """Both bodies of K2 (the shared-neighbourhood body, the wrapper's, at
    several `min_share`: always staged, the wrapper's, never staged; one
    thread a query) on the seeding's layout (runs of one neighbourhood
    from 1 query to longer than several warps, (0, 0) and border points)
    visited view-major (in tiles of 1, 7 and the wrapper's rows, and in
    one tile), and on queries with a point each (one-query runs), each
    also shuffled (the sorted plan), with forced distance ties on a
    lattice grid: identical to the plain version."""
    _, ctx = scene
    rng = np.random.default_rng(20 + M + 10 * ties)
    grids = ctx.grids
    if ties:
        V, GH, GW, _, _ = grids.shape
        grids = torch.as_tensor(_tie_grid(rng, V, GH, GW), device=ctx.device)
    V, GH, GW = grids.shape[:3]
    W, H = GW * ctx.cell, GH * ctx.cell
    a = _k2_seeding_queries(rng, grids, ctx.cell, torch.float32)
    S = 600                                 # a point a query
    starts = np.stack([rng.uniform(-8, W + 8, S),
                       rng.uniform(-8, H + 8, S)], 1)
    pts = np.repeat(starts, V, 0) + rng.normal(0, 3.0, (S * V, 2))
    if ties:
        pts = np.round(pts) + 0.5
    ang = rng.choice([0.0, np.pi / 2], S * V) if ties else \
        rng.uniform(0, np.pi, S * V)
    ab = np.stack([np.cos(ang), np.sin(ang)], 1).round(6)
    c = -(ab * pts).sum(1) + rng.integers(-3, 4, S * V)
    as_t = lambda x: torch.as_tensor(x, device=ctx.device)
    scattered = (grids, as_t(np.tile(np.arange(V), S).astype(np.int32)),
                 as_t(pts.astype(np.float32)),
                 as_t(np.concatenate([ab, c[:, None]], 1).astype(np.float32)),
                 as_t(rng.uniform(3.0, 30.0, S * V).astype(np.float32)))
    for layout in (a, scattered):
        ref = detection._epipolar_topm_plain(*layout, ctx.cell, M, exclude)
        perm = as_t(rng.permutation(len(layout[1])))
        shuffled = (grids, *(t[perm] for t in layout[1:]))
        ref_s = detection.Candidates(*(t[perm] for t in ref))
        runs = [(layout, True, ref), (shuffled, False, ref_s)]
        for args, cyc, want in runs:
            got = detection.epipolar_topm_query(*args, ctx.cell, M, exclude,
                                                view_cycle=cyc)
            ms2, tr = detection.K2_MIN_SHARE, detection.K2_TILE_ROWS
            bodies = [(b, ms2, tr) for b in K2_BODIES] + [
                ("shared", 1, tr), ("shared", 33, tr), ("shared", ms2, 0),
                ("shared", ms2, 1), ("shared", ms2, 7)]
            outs = [_k2_launch((*args, ctx.cell, M), b, cyc, exclude, ms, t)
                    for b, ms, t in bodies]
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert torch.equal(x, y)
            for (b, ms, t), out in zip(bodies, outs):
                for x, y in zip(out, want):
                    assert torch.equal(x, y), (b, ms, t, cyc)
        assert ref.valid.any()


def test_group_seeds_on_gpu_match_cpu(scene, groups):
    sfmd, ctx = scene
    sg, gg = polyline_stages.seeds_from_match_sets(groups, ctx)
    sc, gc = polyline_stages.seeds_from_match_sets(groups, _cpu_ctx(ctx))
    assert len(gc) > 0
    np.testing.assert_array_equal(gg, gc)
    for k in ("cams", "pl_id", "seg"):
        np.testing.assert_array_equal(sg[k], sc[k], err_msg=k)
    for k in ("t", "xy", "X"):
        np.testing.assert_allclose(sg[k], sc[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_similarity_edges_on_gpu_match_host(scene):
    """The f64 matmul edge build on the card against the host clique
    build: the same nodes and edges in the same order, the same f32
    weights (so equal Jaccard fractions stay equal LP ties)."""
    sfmd, ctx = scene
    u_h, e_h, w_h = polyline_stages.similarity_graph(sfmd, ctx, host=True)
    u_d, e_d, w_d = polyline_stages.similarity_graph(sfmd, ctx, host=False)
    assert len(e_h) > 100
    np.testing.assert_array_equal(u_d, u_h)
    np.testing.assert_array_equal(e_d, e_h)
    np.testing.assert_array_equal(w_d, w_h)


def test_similarity_match_sets_on_gpu_match_cpu(scene):
    """Stage-1 match sets on the card (K1, f64 edges, LP on the card)
    equal the CPU context's (plain K1, host edges, LP on the CPU), set
    for set."""
    sfmd, ctx = scene
    gpu = polyline_stages.similarity_match_sets(sfmd, ctx)
    cpu = polyline_stages.similarity_match_sets(sfmd, _cpu_ctx(ctx))
    assert len(gpu) == len(cpu) > 0
    for a, b in zip(gpu, cpu):
        np.testing.assert_array_equal(a, b)


def test_lp_bucket_sums_on_gpu_are_ordered(cuda):
    """Each (receiver, label) bucket is summed in update order on the
    card exactly as on the CPU: weights spanning 9 decades make every
    other order round differently."""
    rng = np.random.default_rng(0)
    n, E = 500, 200000
    src = torch.as_tensor(rng.integers(0, n, E))
    dst = torch.as_tensor(rng.integers(0, n, E))
    ww = torch.as_tensor((10.0 ** rng.uniform(-6, 3, E)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, 7, n))
    cpu = communities._bucket_sums(src, dst, ww, labels, n)
    gpu = communities._bucket_sums(src.to(cuda), dst.to(cuda), ww.to(cuda),
                                   labels.to(cuda), n)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("n_comm,size", [(40, 9), (2100, 8)])
def test_label_propagation_on_gpu_matches_cpu(cuda, n_comm, size):
    """LP on the card gives the CPU labels, on a small graph and on one
    above 16,384 nodes, with equal weights where the tie rule decides."""
    rng = np.random.default_rng(n_comm)
    n = n_comm * size
    intra = [(c * size + i, c * size + j) for c in range(n_comm)
             for i in range(size) for j in range(i + 1, size)
             if rng.random() < 0.85]
    a, b = rng.integers(0, n, n // 2), rng.integers(0, n, n // 2)
    edges = np.asarray(intra + [(x, y) for x, y in zip(a, b) if x != y],
                       np.int64)
    for weights in (np.full(len(edges), 0.5, np.float32),
                    rng.choice([0.25, 1 / 3, 0.5], len(edges))
                    .astype(np.float32)):
        cpu = communities.label_propagation(torch.as_tensor(edges),
                                            torch.as_tensor(weights), n)
        gpu = communities.label_propagation(
            torch.as_tensor(edges, device=cuda),
            torch.as_tensor(weights, device=cuda), n)
        assert torch.equal(gpu.cpu(), cpu)
        assert len(torch.unique(cpu)) > n_comm // 4


def test_default_stages_on_gpu(cuda):
    """Stages 1, 2 and 3 on the card against the same code on the CPU,
    on the cube scene where the relaxed closeness ratio makes stage-2
    match sets: all seven kernels launch, both group sweeps make points,
    the stage counts, point count and per-point view lists are equal,
    the points agree within 1e-4 and lie on the cube."""
    from edgegraph3d_tpu_torch.pipeline import (PipelineStats,
                                                reconstruct_all_stages)
    sfmd, imgs, curves = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    cfg = CFG.replace(closeness_max_dist_ratio=1e6)
    ctx = refpoints.build_context(sfmd, extract_plgs(imgs, cfg), cfg,
                                  device=cuda)
    stats = PipelineStats()
    kernels.reset_launch_counts()
    pts = reconstruct_all_stages(sfmd, ctx, stats, max_starting_views=2)
    totals = kernels.launch_totals()
    assert all(totals[k] > 0 for k in kernels.MAIN_PATH_KERNELS), totals
    assert stats.counts["stage1_sweep"] > 0
    assert stats.counts["stage2_sweep"] > 0
    cpu_stats = PipelineStats()
    cpu = reconstruct_all_stages(sfmd, _cpu_ctx(ctx), cpu_stats,
                                 max_starting_views=2)
    assert stats.counts == cpu_stats.counts
    assert len(pts.X) == len(cpu.X)
    np.testing.assert_array_equal(pts.obs_mask, cpu.obs_mask)
    np.testing.assert_allclose(pts.X, cpu.X, rtol=0, atol=1e-4)
    cc = np.concatenate(curves)
    d = np.sqrt(((pts.X[:, None] - cc[None]) ** 2).sum(-1)).min(1)
    assert len(pts.X) > 50 and np.median(d) < 0.03


# ----------------------------------------------------------------------
# K8 ba_blocks and the optional paths on the card
# ----------------------------------------------------------------------

def _ba_problem(layout, device):
    """A perturbed 8-view scene's BA state and observations: "dense"
    (O = V, cam = arange) or "packed" (views shuffled, at most 5 a point,
    a duplicate camera on every third row, a masked slot with cam -1)."""
    from edgegraph3d_tpu_torch.ops import ba
    sfmd, _, _ = synthetic.make_scene(n_cams=8, n_refpoints_per_curve=16,
                                      width=320, height_px=240,
                                      focal=400.0, seed=5)
    rng = np.random.default_rng(0)
    N, V = sfmd.n_points, sfmd.n_cameras
    w = torch.as_tensor(rng.normal(0, 0.002, (V, 3)))
    R0 = ba.exp_so3(w).numpy() @ sfmd.R
    arrays = [sfmd.K, R0, sfmd.t + rng.normal(0, 0.005, sfmd.t.shape),
              sfmd.points + rng.normal(0, 0.01, sfmd.points.shape)]
    state = ba.BAState(*(torch.as_tensor(np.asarray(a, np.float32),
                                         device=device) for a in arrays))
    O = V if layout == "dense" else 6
    cam = np.full((N, O), -1, np.int32)
    xy = np.zeros((N, O, 2), np.float32)
    mask = np.zeros((N, O), bool)
    for n in range(N):
        if layout == "dense":
            cam[n] = np.arange(V)
            xy[n, sfmd.obs_cam[n]] = sfmd.obs_xy[n]
            mask[n, sfmd.obs_cam[n]] = True
            continue
        order = rng.permutation(len(sfmd.obs_cam[n]))[:5]
        cam[n, :len(order)] = sfmd.obs_cam[n][order]
        xy[n, :len(order)] = sfmd.obs_xy[n][order]
        mask[n, :len(order)] = True
        if n % 3 == 0:
            cam[n, 5], xy[n, 5], mask[n, 5] = cam[n, 0], xy[n, 0], True
    obs = [torch.as_tensor(a, device=device) for a in (cam, xy, mask)]
    return state, obs


def random_ba_problem(V, N, layout, seed=0):
    """A seeded BA problem as numpy f32 arrays (K, R, t, X) and (cam, xy,
    mask): V cameras 4 units from the origin looking at it, N points in
    a ball of radius 0.5, observations with 0.5 px of noise, the poses
    and points perturbed (rotations 0.002 rad, t 0.005, X 0.01).
    "dense": O = V, cam = arange(V), each view present with probability
    0.7 (at least min(V, 2) a point).  "packed": O = min(V, 5) + 1,
    2-5 distinct views a point (1 when V = 1) in random order, a
    duplicate of the first in the last slot on every third row, the
    other slots masked with cam -1.  With V >= 2 every point sees two
    views, so Hxx is well conditioned and sum orders move its inverse
    only by f32 rounding."""
    from edgegraph3d_tpu_torch.ops import ba
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(V, 3))
    c = 4.0 * c / np.linalg.norm(c, axis=1, keepdims=True)
    z = -c / 4.0
    x = np.cross(z, rng.normal(size=(V, 3)))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    t = -np.einsum("vij,vj->vi", R, c)
    K = np.tile(np.array([[400.0, 0.0, 160.0], [0.0, 400.0, 120.0],
                          [0.0, 0.0, 1.0]]), (V, 1, 1))
    K[:, 0, 0] += rng.uniform(-20, 20, V)
    u = rng.normal(size=(N, 3))
    X = 0.5 * rng.uniform(0, 1, (N, 1)) ** (1 / 3) * u / np.linalg.norm(
        u, axis=1, keepdims=True)
    q = np.einsum("vij,nj->nvi", R, X) + t
    proj = np.einsum("vij,nvj->nvi", K, q / q[..., 2:])[..., :2]
    proj += rng.normal(0, 0.5, proj.shape)
    if layout == "dense":
        O = V
        cam = np.tile(np.arange(V, dtype=np.int32), (N, 1))
        mask = rng.random((N, V)) < 0.7
        two = np.argsort(rng.random((N, V)), axis=1)[:, :2]
        mask[np.arange(N)[:, None], two] = True
        xy = np.where(mask[..., None], proj, 0.0)
    else:
        O = min(V, 5) + 1
        cam = np.full((N, O), -1, np.int32)
        xy = np.zeros((N, O, 2))
        mask = np.zeros((N, O), bool)
        for n in range(N):
            k = 1 if V == 1 else int(rng.integers(2, min(V, 5) + 1))
            views = rng.permutation(V)[:k]
            cam[n, :k], xy[n, :k], mask[n, :k] = views, proj[n, views], True
            if n % 3 == 0:
                cam[n, -1], xy[n, -1], mask[n, -1] = views[0], xy[n, 0], True
    w = rng.normal(0, 0.002, (V, 3))
    R = ba.exp_so3(torch.as_tensor(w)).numpy() @ R
    t = t + rng.normal(0, 0.005, t.shape)
    X = X + rng.normal(0, 0.01, X.shape)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(K), f32(R), f32(t), f32(X)), (cam, f32(xy), mask)


def _on(device, arrays, obs):
    from edgegraph3d_tpu_torch.ops import ba
    state = ba.BAState(*(torch.as_tensor(a, device=device) for a in arrays))
    return state, [torch.as_tensor(a, device=device) for a in obs]


#: (layout, V, N) of the random problems K8 is held to: V around the
#: lane boundaries (one, two and three 32-view passes), N not a multiple
#: of a block's 8 points, and a view with more observations than one
#: block of the view sums takes (1,024)
BA_KERNEL_CASES = [
    pytest.param("packed", None, None, id="packed"),
    pytest.param("dense", None, None, id="dense"),
    *(pytest.param(layout, V, 203, id=f"{layout}-V{V}")
      for V in (1, 31, 32, 33, 65) for layout in ("dense", "packed")),
    pytest.param("dense", 4, 3001, id="dense-V4-chunks"),
]


@pytest.mark.parametrize("layout,V,N", BA_KERNEL_CASES)
def test_ba_blocks_kernel_matches_plain(cuda, layout, V, N):
    """K8 against its plain version on the same card inputs: every
    output within 2e-5 of the array's largest magnitude (the sums run in
    another order), the observation count exact, and two launches bit
    for bit the same (no float atomics).  The 8-view scene's problems
    (V None) and the random ones; at V = 1 a point sees one view, its
    depth is unobservable and Hxx has rank 2, so that case runs with
    damping 1 (the condition number of Hxx + damping diag(Hxx) would
    otherwise multiply f32 rounding by ~1e4)."""
    from edgegraph3d_tpu_torch.ops import ba
    if V is None:
        state, obs = _ba_problem(layout, cuda)
    else:
        state, obs = _on(cuda, *random_ba_problem(V, N, layout))
    damping = 1.0 if V == 1 else 1e-4
    n0 = kernels.launch_totals()["ba_blocks"]
    got = ba.ba_blocks(state, *obs, damping=damping)
    torch.cuda.synchronize()
    assert kernels.launch_totals()["ba_blocks"] == n0 + 1
    ref = ba._ba_blocks_plain(state, *obs, damping=damping)
    for name in ba.BABlocks._fields:
        g, r = getattr(got, name), getattr(ref, name)
        assert g.shape == r.shape, name
        if name == "n_obs":
            assert int(g) == int(r) == int(obs[2].sum())
            continue
        scale = max(float(r.abs().max()), 1e-30)
        assert float((g - r).abs().max()) <= 2e-5 * scale, name
    again = ba.ba_blocks(state, *obs, damping=damping)
    for name in ba.BABlocks._fields:
        assert torch.equal(getattr(again, name), getattr(got, name)), name


@pytest.mark.parametrize("V,where", [(70, "static"), (71, "optin"),
                                     (338, "optin"), (339, "global")])
def test_ba_blocks_tile_placements(cuda, V, where):
    """K8's point-kernel tables at their byte boundaries (684 V + 1,024
    bytes: the camera table, the staged A tile and the slot masks; 48 KiB
    of shared memory up to V = 70, opted in up to V = 338 on an H100,
    else cameras from device memory and A stored from the lanes): the
    bytes as the C source counts them, the placement the wrapper
    records, and every output within 2e-5 of the plain version's largest
    magnitude."""
    from edgegraph3d_tpu_torch.ops import ba
    assert kernels.lib().eg3d_ba_blocks_smem(V) == ba.ba_table_bytes(V)
    assert kernels.table_placement(
        ba.ba_table_bytes(V), kernels.smem_optin_bytes(cuda)) == where
    state, obs = _on(cuda, *random_ba_problem(V, 37, "dense", seed=V))
    got = ba.ba_blocks(state, *obs)
    torch.cuda.synchronize()
    assert kernels.LAST_PLACEMENT["ba_blocks"] == where
    ref = ba._ba_blocks_plain(state, *obs)
    for name in ba.BABlocks._fields:
        g, r = getattr(got, name), getattr(ref, name)
        scale = max(float(r.abs().max()), 1e-30)
        assert float((g - r).abs().max()) <= 2e-5 * scale, name


def test_observation_index_on_card_matches_cpu(cuda):
    """The index built on the card (a stable sort on the device) equals
    the one built on the CPU, on the packed layout with duplicates and
    -1 cameras."""
    from edgegraph3d_tpu_torch.ops import ba
    _, (cam, _, mask) = random_ba_problem(33, 500, "packed")
    a = ba.observation_index(torch.as_tensor(cam, device=cuda),
                             torch.as_tensor(mask, device=cuda), 33)
    b = ba.observation_index(torch.as_tensor(cam), torch.as_tensor(mask), 33)
    for name in ("slot", "start", "first"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    assert a.max_count == b.max_count


def test_ba_run_index_once_on_card(cuda):
    """ba_run (the index built once) against steps that each rebuild it:
    bit for bit on the card."""
    from edgegraph3d_tpu_torch.ops import ba
    state, obs = _on(cuda, *random_ba_problem(33, 203, "packed"))
    st, mses = ba.ba_run(state, *obs, 3)
    st2, mses2 = state, []
    for _ in range(3):
        st2, mse = ba.ba_step_single(st2, *obs)
        mses2.append(mse)
    for name in ("R", "t", "X"):
        assert torch.equal(getattr(st, name), getattr(st2, name)), name
    assert torch.equal(mses, torch.stack(mses2))


def test_ba_run_on_card_matches_cpu(cuda):
    """Three LM steps with K8 against the plain steps on the CPU: the
    rotations within 1e-5 and the translations within 1e-5 + 1e-5 |t|
    (|t| ~ 4: the f32 6V solve, cuSOLVER's against LAPACK's, moved t by
    1.4e-5 on the card), points within 1e-4, the MSE falls."""
    from edgegraph3d_tpu_torch.ops import ba
    state, obs = _ba_problem("packed", cuda)
    st_g, mse_g = ba.ba_run(state, *obs, 3)
    cpu = lambda a: a.cpu()
    st_c, mse_c = ba.ba_run(ba.BAState(*map(cpu, state)),
                            *map(cpu, obs), 3)
    torch.testing.assert_close(st_g.R.cpu(), st_c.R, rtol=0, atol=1e-5)
    torch.testing.assert_close(st_g.t.cpu(), st_c.t, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st_g.X.cpu(), st_c.X, rtol=0, atol=1e-4)
    assert mse_g.device.type == "cuda"
    assert float(mse_g[-1]) < float(mse_g[0]) * 1e-2


def _claim_problem(rng, V=3, P=16, B=64, S=120):
    """Collision-rich claim chunks (tests/test_claiming.py's generator):
    two managers with the same pre-claimed arcs, and the chunk."""
    lengths = np.full((V, P), 32, np.int32)
    a, b = (matches.MatchesManager(lengths, buckets=B) for _ in range(2))
    for _ in range(5):
        v, p = rng.integers(0, V), rng.integers(0, P)
        lo, hi = sorted(rng.integers(0, B, 2))
        a.raster[v, p, lo:hi + 1] = True
        b.raster[v, p, lo:hi + 1] = True
    seg = rng.integers(0, 30, (S, 3))
    args = (rng.random(S) < 0.9, rng.integers(0, V, (S, 3)),
            rng.integers(0, P, (S, 3)), seg, rng.random((S, 3)),
            np.clip(seg + rng.integers(-8, 9, (S, 3)), 0, 30),
            rng.random((S, 3)),
            np.clip(seg + rng.integers(-8, 9, (S, 3)), 0, 30),
            rng.random((S, 3)))
    return a, b, args


def test_device_claiming_on_card_matches_host(cuda):
    """The fixpoint on the card: the host pass's accept masks and
    raster, bit for bit, on four collision-rich chunks with the start
    check and without it, and no fallback."""
    from edgegraph3d_tpu_torch.matching import claiming_device
    rng = np.random.default_rng(0)
    for _ in range(4):
        host, dev, args = _claim_problem(rng)
        for skip in (False, True):
            a_h = host.resolve_and_claim(*args, skip_start_check=skip)
            a_d = claiming_device.apply_device_claiming(
                dev, *args, skip_start_check=skip, device=cuda)
            np.testing.assert_array_equal(a_d, a_h)
            np.testing.assert_array_equal(dev.raster, host.raster)
        assert "device_claiming_fallback" not in dev.counters


def test_optional_paths_on_gpu(cuda):
    """run_pipeline with joint BA (K8) and device claiming on the card
    against the same run on the CPU: the same points and view lists
    (points within 1e-4), K8 launched once a step, no claiming fallback.
    The LMedS table on the card: epipolar lines within 0.5 px of the
    refpoints' observations (on this noise-free scene many subsets tie,
    so the card's and the CPU's tables are not compared entry by
    entry)."""
    from edgegraph3d_tpu_torch.pipeline import PipelineStats, run_pipeline
    sfmd, imgs, _ = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    cfg = CFG.replace(ba_steps=2, claiming_backend="device")
    kernels.reset_launch_counts()
    stats = PipelineStats()
    gpu = run_pipeline(sfmd, imgs, cfg, max_starting_views=2, stats=stats,
                       device=cuda)
    assert kernels.launch_totals()["ba_blocks"] == 2
    assert "device_claiming_fallback" not in stats.counters
    assert stats.metrics["ba_mse_after"] < stats.metrics["ba_mse_before"]
    cpu = run_pipeline(sfmd, imgs, cfg, max_starting_views=2, device="cpu")
    assert gpu.n_points == cpu.n_points > sfmd.n_points
    assert [c.tolist() for c in gpu.obs_cam] == \
        [c.tolist() for c in cpu.obs_cam]
    np.testing.assert_allclose(gpu.points, cpu.points, rtol=0, atol=1e-4)

    F = refpoints.lmeds_fundamental_table(sfmd, CFG, device=cuda).cpu()
    obs_xy, obs_mask = refpoints.dense_observations(sfmd)
    common = obs_mask.T.astype(int) @ obs_mask.astype(int)
    pairs = [(i, j) for i in range(8) for j in range(8)
             if i != j and common[i, j] >= 20]
    assert len(pairs) >= 3
    for i, j in pairs:
        m = obs_mask[:, i] & obs_mask[:, j]
        x1 = np.concatenate([obs_xy[m][:, i], np.ones((m.sum(), 1))], 1)
        x2 = np.concatenate([obs_xy[m][:, j], np.ones((m.sum(), 1))], 1)
        lines = x1 @ F[i, j].numpy().T
        d = np.abs((lines * x2).sum(1)) / np.linalg.norm(lines[:, :2], axis=1)
        assert np.median(d) < 0.5, (i, j)


@pytest.fixture(scope="module")
def second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs: a launch on cuda:1 while cuda:0 "
                    "is current")
    return torch.device("cuda", 1)


def test_kernels_launch_on_their_tensors_card(scene, chains, second_card):
    """K1, K3 and K7 on tensors of cuda:1 while cuda:0 is the current
    device (kernels.on_device): each result equals the cuda:0 launch's,
    and the current device is left as it was."""
    sfmd, ctx = scene
    other = ctx.on(second_card)
    torch.cuda.set_device(0)
    view, pts = _queries(ctx, 4099, 5)
    ref = detection.grid_topm_query(ctx.grids, view, pts, ctx.cell, 10.0, 4)
    got = detection.grid_topm_query(other.grids, view.to(second_card),
                                    pts.to(second_card), ctx.cell, 10.0, 4)
    assert got.pl_id.device == second_card
    _assert_same_candidates(
        detection.Candidates(*(a.to(ctx.device) for a in got)), ref)
    rng = np.random.default_rng(3)
    X, cams, xy, mask = _gn_problem(sfmd, sfmd.P, 5000, 3, rng)
    gn = lambda c, d: triangulation.triangulate_gn(
        c.P_mats, torch.as_tensor(cams, device=d),
        torch.as_tensor(xy, device=d), torch.as_tensor(mask, device=d))
    for a, b in zip(gn(other, second_card), gn(ctx, ctx.device)):
        assert torch.equal(a.cpu(), b.cpu())
    C, T, extent, tensors = chains
    k7 = lambda c, d: expansion.expand_chains_compact(
        c.plg_coords, c.grids, c.P_mats, c.F_table, c.cell,
        *(a.to(d) for a in tensors), c.config, C, T, extent)
    for a, b in zip(k7(other, second_card), k7(ctx, ctx.device)):
        assert torch.equal(a.cpu(), b.cpu())
    assert torch.cuda.current_device() == 0


def test_stage3_on_a_mesh_of_cards_matches_one_card(scene, second_card):
    """Stage 3 on a mesh over every card equals the one-card run."""
    from edgegraph3d_tpu_torch.parallel.mesh import make_mesh
    sfmd, ctx = scene
    one = refpoints.reconstruct_from_refpoints(sfmd, ctx,
                                               max_starting_views=2)
    mctx = refpoints.build_context(
        sfmd, extract_plgs(synthetic.make_scene(
            n_cams=8, n_refpoints_per_curve=16, width=320, height_px=240,
            focal=400.0, seed=3)[1], CFG), CFG, mesh=make_mesh())
    pts = refpoints.reconstruct_from_refpoints(sfmd, mctx,
                                               max_starting_views=2)
    assert len(pts.X) == len(one.X) > 0
    np.testing.assert_array_equal(pts.X, one.X)
    np.testing.assert_array_equal(pts.obs_mask, one.obs_mask)


# ----------------------------------------------------------------------
# the f64 instantiations (EdgeGraphConfig(dtype="float64")): K1-K5, K7
# ----------------------------------------------------------------------
#
# Each double body against its plain twin in f64 on the same card
# tensors.  Both sides round each operation once in f64 (the walk's fused
# multiply-adds: the hardware fma and ops.geometry._fma, both correctly
# rounded), so decisions must be equal and coordinates agree to 1e-9.

F64_TOL = 1e-9


@pytest.fixture(scope="module")
def scene64(scene):
    sfmd, ctx = scene
    cfg = CFG.replace(dtype="float64")
    stack = extract_plgs(synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=16, width=320, height_px=240,
        focal=400.0, seed=3)[1], cfg)
    ctx64 = refpoints.build_context(sfmd, stack, cfg, device=ctx.device)
    assert ctx64.P_mats.dtype == ctx64.F_table.dtype == torch.float64
    assert ctx64.plg_coords.dtype == torch.float64
    assert ctx64.grids.dtype == torch.float32
    return sfmd, ctx64


def _assert_same_candidates64(a, b):
    for f in ("pl_id", "seg", "valid"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("t", "xy", "dist"):
        assert getattr(a, f).dtype == torch.float64, f
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=F64_TOL)


@pytest.mark.parametrize("M", [1, 2, 4])
def test_f64_grid_topm_kernel_matches_plain(scene64, M):
    _, ctx = scene64
    view, pts = _queries(ctx, 20001, 30 + M)
    pts = pts.double() + 1e-4 * torch.rand_like(pts, dtype=torch.float64)
    n0 = kernels.LAUNCHES["grid_topm_query"]["float64"]
    got = detection.grid_topm_query(ctx.grids, view, pts, ctx.cell, 10.0, M)
    assert kernels.LAUNCHES["grid_topm_query"]["float64"] == n0 + 1
    ref = detection._grid_topm_plain(ctx.grids, view, pts, ctx.cell, 10.0,
                                     M)
    torch.cuda.synchronize()
    assert ref.valid.any()
    _assert_same_candidates64(got, ref)


@pytest.mark.parametrize("pts64", [False, True])
@pytest.mark.parametrize("exclude", [None, 0.965])
def test_f64_epipolar_topm_kernel_matches_plain(scene64, exclude, pts64):
    """f64 lines over f32 points (the seeding) and over f64 points (the
    expansion's plain version)."""
    _, ctx = scene64
    view, pts = _queries(ctx, 20000, 17)
    rng = np.random.default_rng(18)
    p = pts.cpu().numpy().astype(np.float64)
    ang = rng.uniform(0, np.pi, len(p))
    ab = np.stack([np.cos(ang), np.sin(ang)], 1)
    c = -(ab * p).sum(1) + rng.normal(0, 5.0, len(p))
    lines = torch.as_tensor(np.concatenate([ab, c[:, None]], 1),
                            device=ctx.device)
    radius = torch.as_tensor(rng.uniform(3.0, 30.0, len(p))
                             .astype(np.float32), device=ctx.device)
    if pts64:
        pts = pts.double()
    n0 = kernels.LAUNCHES["epipolar_topm_query"]["float64"]
    got = detection.epipolar_topm_query(ctx.grids, view, pts, lines, radius,
                                        ctx.cell, 4, exclude)
    assert kernels.LAUNCHES["epipolar_topm_query"]["float64"] == n0 + 1
    ref = detection._epipolar_topm_plain(ctx.grids, view, pts, lines,
                                         radius, ctx.cell, 4, exclude)
    torch.cuda.synchronize()
    assert ref.valid.any()
    _assert_same_candidates64(got, ref)
    # the seeding's layout visited view-major and shuffled (the sorted
    # plan), through the wrapper and every body, each identical to the
    # wrapper's view-major result
    a = _k2_seeding_queries(rng, ctx.grids, ctx.cell, torch.float64,
                            torch.float64 if pts64 else torch.float32)
    ref = detection._epipolar_topm_plain(*a, ctx.cell, 4, exclude)
    got = detection.epipolar_topm_query(*a, ctx.cell, 4, exclude,
                                        view_cycle=True)
    perm = torch.as_tensor(rng.permutation(len(a[1])), device=ctx.device)
    shuffled = (ctx.grids, *(t[perm] for t in a[1:]))
    want_s = detection.Candidates(*(t[perm] for t in got))
    runs = [(a, True, got), (shuffled, False, want_s)]
    outs = [(_k2_launch((*args, ctx.cell, 4), b, cyc, exclude), want, b)
            for args, cyc, want in runs for b in K2_BODIES]
    outs.append((detection.epipolar_topm_query(*shuffled, ctx.cell, 4,
                                               exclude), want_s, "wrapper"))
    torch.cuda.synchronize()
    assert ref.valid.any()
    _assert_same_candidates64(got, ref)
    for out, want, b in outs:
        for x, y in zip(out, want):
            assert torch.equal(x, y), b


@pytest.mark.parametrize("O,warm,V_big", [(3, False, 0), (3, True, 0),
                                          (8, False, 0), (8, True, 0),
                                          (4, False, 1100),
                                          (4, False, 5000)])
def test_f64_triangulate_gn_kernel_matches_plain(scene64, O, warm, V_big):
    """The O = 3 register body in double and the general body's padded
    loop, its double table in shared memory, opted in (1,100 cameras) or
    in device memory (5,000)."""
    sfmd, ctx = scene64
    rng = np.random.default_rng(O + 10 * warm + V_big)
    P = ctx.P_mats
    if V_big:
        P = P[torch.arange(V_big, device=ctx.device) % P.shape[0]]
        n_bytes = triangulation.gn_table_bytes(V_big, torch.float64)
        assert kernels.lib().eg3d_triangulate_gn_smem_f64(V_big, 4) \
            == n_bytes
        where = kernels.table_placement(n_bytes,
                                        kernels.smem_optin_bytes(ctx.device))
        assert where == ("optin" if V_big == 1100 else "global")
    X, cams, xy, mask = _gn_problem(sfmd, P.cpu().numpy(), 8192, O, rng)
    dev = ctx.device
    args = (P, torch.as_tensor(cams, device=dev),
            torch.as_tensor(xy.astype(np.float64), device=dev),
            torch.as_tensor(mask, device=dev))
    X0 = torch.as_tensor(X + rng.normal(0, 0.02, X.shape), device=dev) \
        if warm else None
    iters = 8 if warm else 30
    Xk, msek, okk = triangulation.triangulate_gn(*args, X0=X0,
                                                 max_iters=iters)
    if O != 3:
        assert kernels.LAST_PLACEMENT["triangulate_gn"] == (
            where if V_big else "static")
    Xp, msep, okp = triangulation._triangulate_gn_plain(
        *args, X0, iters, 5e-7, 9.0, 1e-5)
    torch.cuda.synchronize()
    assert Xk.dtype == torch.float64
    assert okp.any() and torch.equal(okk, okp)
    torch.testing.assert_close(Xk[okp], Xp[okp], rtol=F64_TOL, atol=F64_TOL)
    torch.testing.assert_close(msek[okp], msep[okp], rtol=F64_TOL,
                               atol=F64_TOL)


@pytest.mark.parametrize("warm,T", [(False, 32), (True, 1)])
def test_f64_follow_walk_kernel_matches_plain(scene64, warm, T):
    sfmd, ctx = scene64
    seeds = _scene_seeds(sfmd, ctx)
    S = len(seeds["cams"])
    dev = ctx.device
    rng = np.random.default_rng(40 + T)
    dirs = torch.as_tensor(rng.choice([-1, 1], (S, 3)).astype(np.int32),
                           device=dev)
    args = _follow_args(ctx, seeds, torch.arange(S, device=dev), dirs,
                        torch.ones(S, dtype=torch.bool, device=dev), warm)
    args = args[:7] + (args[7].double(),) + args[8:]  # t, as seeding gives
    n0 = kernels.LAUNCHES["follow_walk"]["float64"]
    got = following.follow_walk(*args, T, ctx.config)
    assert kernels.LAUNCHES["follow_walk"]["float64"] == n0 + 1
    ref = _plain_follow(args, T, ctx.config)
    torch.cuda.synchronize()
    assert got.X.dtype == torch.float64 and ref.valid[:, 0].any()
    for f in ("valid", "n_steps", "seg", "final_seg"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("obs", "t", "final_t", "X"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=F64_TOL, msg=f)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("W,S,offset,same", [
    (128, 9999, 0, False), (7, 9999, 1, False), (64, 9999, 0, False),
    (32, 9999, 0, False), (16, 9999, 0, False), (4, 9999, 0, False),
    (1, 9999, 0, False), (66, 9999, 0, False), (130, 9999, 0, False),
    (64, 2**20 + 3, 0, False), (64, 9999, 0, True), (64, 9999, 1, False)])
def test_f64_gather_rows_kernel_matches_plain(cuda, W, S, offset, same,
                                              dtype):
    """The double2 bodies (even W, aligned: 32, 16, 8 pieces, the general
    one at 2, 33 and 65) and the scalar one (odd W, a view 8 bytes off
    16-byte alignment), S past the grid and one row copied S times, with
    int32 and int64 indices."""
    table, rows = _k5_inputs(cuda, 4096, W, S, offset, same, torch.float64,
                             dtype)
    n0 = kernels.LAUNCHES["gather_rows"]["float64"]
    got = gather_rows(table, rows)
    assert kernels.LAUNCHES["gather_rows"]["float64"] == n0 + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and torch.equal(got,
                                                      table[rows.long()])


@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_f64_expand_chains_kernel_matches_plain(scene64, chains, mode):
    """K7's double body (X and obs3 handed over in f32 and promoted, as
    the caller hands them) against its plain version on the card."""
    _, ctx = scene64
    C, T, extent, tensors = chains
    cfg = ctx.config.replace(expand_correspondence_mode=mode)
    args = (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            *tensors, cfg, C, T)
    n0 = kernels.LAUNCHES["expand_chains"]["float64"]
    Xk, xyk, okk = expansion.expand_chains_compact(*args, extent)
    assert kernels.LAUNCHES["expand_chains"]["float64"] == \
        n0 + _k7_launches(extent)
    Xp, xyp, okp = expansion._expand_chains_compact_plain(*args)
    torch.cuda.synchronize()
    assert Xk.dtype == xyk.dtype == torch.float64
    assert okp.sum(1).max() > 3
    assert torch.equal(okk, okp)
    torch.testing.assert_close(xyk, xyp, rtol=0, atol=F64_TOL)
    torch.testing.assert_close(Xk, Xp, rtol=0, atol=F64_TOL)


def test_f64_stage3_on_gpu_matches_cpu(scene64):
    """The stage-3 slice in f64 on the card (the f64 kernels) against the
    same code on the CPU (the plain twins in f64)."""
    sfmd, ctx = scene64
    kernels.reset_launch_counts()
    gpu = refpoints.reconstruct_from_refpoints(sfmd, ctx,
                                               max_starting_views=2)
    for k in kernels.F64_KERNELS:
        assert kernels.LAUNCHES[k]["float64"] > 0, k
    cpu = refpoints.reconstruct_from_refpoints(sfmd, _cpu_ctx(ctx),
                                               max_starting_views=2)
    assert len(gpu.X) == len(cpu.X) > 0
    np.testing.assert_array_equal(gpu.obs_mask, cpu.obs_mask)
    np.testing.assert_allclose(gpu.X, cpu.X, rtol=0, atol=F64_TOL)


# ----------------------------------------------------------------------
# K9 lmeds7_fit: OpenCV's FM_LMEDS over every pair at once
# ----------------------------------------------------------------------

LMEDS_CFG = EdgeGraphConfig().replace(fmat_source="opencv_lmeds")


def _unit_gap(a, b):
    """Largest entry difference of unit-Frobenius F up to sign, per pair."""
    return torch.minimum((a - b).abs().amax((-2, -1)),
                         (a + b).abs().amax((-2, -1)))


def _lmeds_inputs(sfmd, dev, trials=300):
    """fundamental_lmeds_opencv's inputs for every ordered pair of sfmd
    with at least 8 common refpoints, on dev."""
    xy, mask = refpoints.dense_observations(sfmd)
    m = mask.astype(np.int64)
    common = m.T @ m
    V = sfmd.n_cameras
    pairs = np.asarray([(i, j) for i in range(V) for j in range(V)
                        if i != j and common[i, j] >= 8])
    n = torch.as_tensor(common[pairs[:, 0], pairs[:, 1]])
    pi = torch.as_tensor(pairs, device=dev)
    x1, x2 = refpoints.common_points(
        torch.as_tensor(xy, device=dev), torch.as_tensor(mask, device=dev),
        pi[:, 0], pi[:, 1], int(n.max()))
    return x1, x2, n, geometry.lmeds7_samples(n, trials)


def _assert_lmeds_agree(got, want, decided=None):
    """K9 against the plain twin on the same samples: the same validity
    and the same models and samples without one a pair; on the pairs
    `decided` (all by default) the same winning sample and inliers, F
    within 1e-9 per entry and the scores within 1e-6 relative.  The
    root's index within the sample (best % 3) follows the null space's
    basis, which the two find differently."""
    got = {k: v.cpu() for k, v in got.items() if torch.is_tensor(v)}
    want = {k: v.cpu() for k, v in want.items() if torch.is_tensor(v)}
    for k in ("valid", "models", "no_model"):
        assert torch.equal(got[k], want[k]), k
    d = torch.ones_like(want["valid"]) if decided is None else decided
    assert torch.equal(got["best"][d] // 3, want["best"][d] // 3)
    assert torch.equal(got["inliers"][d], want["inliers"][d])
    ok = want["valid"] & d
    gap = _unit_gap(got["F"][ok], want["F"][ok])
    assert gap.numel() == 0 or float(gap.max()) < 1e-9
    fin = torch.isfinite(want["score"]) & d
    assert torch.equal(torch.isfinite(got["score"]) & d, fin)
    rel = got["score"][fin].double() / want["score"][fin].double() - 1
    assert rel.numel() == 0 or float(rel.abs().max()) <= 1e-6


@pytest.fixture(scope="module")
def noisy_refpoints(cuda):
    """test_torch_fmat_opencv.py's scene: 6 views, 300 refpoints carrying
    0.5 px of noise, so that no two samples tie."""
    sfmd, _, _ = synthetic.make_dtu_scale_scene(
        n_cams=6, n_refpoints=300, width=400, height_px=300, focal=550.0,
        seed=1)
    rng = np.random.default_rng(0)
    sfmd.obs_xy = [x + rng.normal(0, 0.5, x.shape) for x in sfmd.obs_xy]
    return sfmd


def test_lmeds7_fit_matches_plain(noisy_refpoints, cuda):
    x1, x2, n, samples = _lmeds_inputs(noisy_refpoints, cuda)
    n0 = kernels.LAUNCHES["lmeds7_fit"]["float64"]
    got = lmeds7.lmeds7_fit(x1, x2, n, samples)
    assert kernels.LAUNCHES["lmeds7_fit"]["float64"] == n0 + 1
    assert kernels.LAST_PLACEMENT["lmeds7_fit"] == "static"
    want = geometry.fundamental_lmeds_opencv(x1, x2, n.to(cuda), samples)
    torch.cuda.synchronize()
    assert bool(want["valid"].all())
    _assert_lmeds_agree(got, want)


def test_lmeds7_table_on_card_matches_cpu(noisy_refpoints, cuda):
    """opencv_lmeds_fit on the card (K9, every pair at once) against the
    plain twin's chunked route on the CPU; fmat_pairs_kernel counts the
    pairs K9 scored."""
    sfmd = noisy_refpoints
    card = refpoints.opencv_lmeds_fit(sfmd, LMEDS_CFG, cuda)
    cpu = refpoints.opencv_lmeds_fit(sfmd, LMEDS_CFG, "cpu")
    assert card.pairs_kernel == len(card.pairs) == 30
    assert cpu.pairs_kernel == 0
    none = torch.zeros((len(cpu.pairs), 1))
    _assert_lmeds_agree(dict(vars(card), inliers=none),
                        dict(vars(cpu), inliers=none))
    assert torch.equal(card.samples, cpu.samples)
    stats = pipeline.PipelineStats()
    refpoints.opencv_lmeds_fundamental_table(sfmd, LMEDS_CFG, cuda, stats)
    assert stats.counters["fmat_pairs_kernel"] == 30


def test_lmeds7_card_chunks_do_not_change_the_fit(noisy_refpoints, cuda,
                                                  monkeypatch):
    """One pair a chunk on the card (30 launches of K9, each into its
    rows of the same device tensors) gives the one-chunk fit bit for
    bit."""
    sfmd = noisy_refpoints
    whole = refpoints.opencv_lmeds_fit(sfmd, LMEDS_CFG, cuda)
    monkeypatch.setattr(refpoints, "OPENCV_LMEDS_CARD_CHUNK_BYTES", 1)
    n0 = kernels.LAUNCHES["lmeds7_fit"]["float64"]
    part = refpoints.opencv_lmeds_fit(sfmd, LMEDS_CFG, cuda)
    assert kernels.LAUNCHES["lmeds7_fit"]["float64"] == n0 + 30
    assert part.pairs_kernel == 30
    for k in ("F", "valid", "score", "best", "models", "no_model"):
        assert torch.equal(getattr(part, k), getattr(whole, k)), k


def _far_pairs(ns, seed, outliers=0.2):
    """Pairs of noisy correspondences (0.5 px, a share `outliers` moved
    30-80 px) of two 640x480 views, n[p] points each, padded to the
    largest: x1, x2 [P, N, 2] f32 on the CPU."""
    rng = np.random.default_rng(seed)
    N = max(ns)
    x1 = np.zeros((len(ns), N, 2), np.float32)
    x2 = np.zeros_like(x1)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    for p, n in enumerate(ns):
        X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]
        t = rng.normal(0, 1, 3)
        w = rng.normal(0, 0.2, 3)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]]) / th
        R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
        for out, (Rc, tc) in ((x1, (np.eye(3), np.zeros(3))), (x2, (R, t))):
            h = (X @ Rc.T + tc) @ K.T
            out[p, :n] = h[:, :2] / h[:, 2:] + rng.normal(0, 0.5, (n, 2))
        bad = rng.random(n) < outliers
        x2[p, :n][bad] += rng.uniform(30, 80, (int(bad.sum()), 2))
    return torch.as_tensor(x1), torch.as_tensor(x2)


def test_lmeds7_fit_streams_pairs_above_shared_memory(cuda):
    """Pairs larger than the opt-in shared memory holds (over 14,012)
    are read from device memory, with the same results."""
    ns = [15000, 9001, 14500]
    x1, x2 = (t.to(cuda) for t in _far_pairs(ns, 3))
    n = torch.tensor(ns)
    samples = geometry.lmeds7_samples(n, 300)
    got = lmeds7.lmeds7_fit(x1, x2, n, samples)
    assert kernels.LAST_PLACEMENT["lmeds7_fit"] == "global"
    want = geometry.fundamental_lmeds_opencv(x1, x2, n.to(cuda), samples)
    torch.cuda.synchronize()
    assert bool(want["valid"].all())
    _assert_lmeds_agree(got, want)


def test_lmeds7_fit_small_pairs_and_samples_without_a_model(cuda):
    """Pairs under max(min_points, 8) points are fit but not valid; a
    pair whose points coincide in both views, or in one, has no model at
    all (no spread).  Under 14 points the upper median falls among a
    sample's own 7 points, so rounding picks the winner there: those
    pairs are held to the same decisions only."""
    ns = [7, 9, 40, 40, 40]
    x1, x2 = _far_pairs(ns, 4, outliers=0.0)
    x1[2, :40] = x1[2, 0]
    x2[2, :40] = x2[2, 0]
    x1[3, :40] = x1[3, 0]
    x1, x2 = x1.to(cuda), x2.to(cuda)
    n = torch.tensor(ns)
    samples = geometry.lmeds7_samples(n, 45)
    got = lmeds7.lmeds7_fit(x1, x2, n, samples, min_points=10)
    want = geometry.fundamental_lmeds_opencv(x1, x2, n.to(cuda), samples,
                                             min_points=10)
    torch.cuda.synchronize()
    assert want["valid"].tolist() == [False, False, False, False, True]
    assert want["models"][2] == want["models"][3] == 0
    assert want["no_model"][2] == want["no_model"][3] == 45
    assert bool(torch.isinf(want["score"][2]))
    assert want["models"][0] > 0
    _assert_lmeds_agree(got, want, decided=n >= 14)


@pytest.mark.parametrize("n", [1, 2556, 2557, 6268, 14012])
def test_lmeds7_smem_bytes(cuda, n):
    assert kernels.lib().eg3d_lmeds7_smem(n) == lmeds7.smem_bytes(n)


def test_lmeds7_fit_full_size_within_the_tools_tolerances(cuda):
    """dtu49_cvlmeds at full size (2,352 pairs of 6,268 noise-free
    refpoints, 300 samples), one seed: K9's table against the plain
    twin's on the card (its chunk loop, as the route was before K9),
    within tools/check_fmat_on_card.py's tolerances."""
    import json
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    import check_fmat_on_card as tool
    from h100bench import scenes
    from h100bench.run import edge_graph_config, program_scene

    with open(os.path.join(root, "h100bench", "configs",
                           "dtu49_cvlmeds.json")) as f:
        conf = json.load(f)
    scene = scenes.make(conf["scene"], 2718281828)
    cfg = edge_graph_config(conf)
    sfmd = program_scene(scene)
    fit = refpoints.opencv_lmeds_fit(sfmd, cfg, cuda)
    assert fit.pairs_kernel == len(fit.pairs) == 2352
    x1, x2, n, samples = _lmeds_inputs(sfmd, cuda)
    assert torch.equal(samples, fit.samples)
    want = {k: [] for k in ("F", "valid", "score", "best")}
    for lo in range(0, len(n), 11):
        part = geometry.fundamental_lmeds_opencv(
            x1[lo:lo + 11], x2[lo:lo + 11], n[lo:lo + 11].to(cuda),
            samples[lo:lo + 11])
        for k in want:
            want[k].append(part[k].cpu())
    want = {k: torch.cat(v) for k, v in want.items()}
    ref = [dict(F=want["F"][p].numpy() if want["valid"][p] else None,
                score=float(want["score"][p]),
                sample=int(want["best"][p]) // 3)
           for p in range(len(n))]
    xy, mask = tool.dense(scene)
    points = [tool.common_points(xy, mask, int(i), int(j))
              for i, j in fit.pairs]
    nums = tool.compare(fit, ref, points, "cuda")
    for name, (tol, sense) in tool.TOLERANCES.items():
        v = nums[name]
        assert (v <= tol if sense == "max" else v >= tol), (name, v, nums)
