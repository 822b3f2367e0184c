"""Hand-written CUDA kernels (K1-K7) against their plain-torch twins.

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

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import synthetic
from edgegraph3d_tpu_torch.matching import (communities, detection,
                                            expansion, following, matches,
                                            polyline_stages, refpoints)
from edgegraph3d_tpu_torch.ops import triangulation
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
    n0 = kernels.LAUNCHES["grid_topm_query"]
    got = detection.grid_topm_query(grids, view, pts, ctx.cell, 10.0, M)
    assert kernels.LAUNCHES["grid_topm_query"] == n0 + 1
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
    n0 = kernels.LAUNCHES["triangulate_gn"]
    Xk, msek, okk = triangulation.triangulate_gn(*args, **kw)
    assert kernels.LAUNCHES["triangulate_gn"] == n0 + 1
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
    n0 = kernels.LAUNCHES["follow_walk"]
    got = following.follow_walk(*args, T, cfg)
    assert kernels.LAUNCHES["follow_walk"] == n0 + 1
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
    assert all(kernels.LAUNCHES[k] > 0 for k in stage3), kernels.LAUNCHES
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("R,W,S,offset", [(65536, 128, 16384, 0),
                                          (4096, 128, 9999, 1),
                                          (1000, 7, 3000, 0)])
def test_gather_rows_kernel_matches_plain(cuda, R, W, S, offset, dtype):
    """Bit-equal to table[rows]: the 16-byte path (W % 4 == 0, aligned)
    and the scalar path (a table view 4 bytes off alignment, odd W),
    with int32 and int64 indices."""
    g = torch.Generator(device=cuda).manual_seed(R + offset)
    base = torch.randn(R * W + offset, generator=g, device=cuda)
    table = base[offset:].view(R, W)
    rows = torch.randint(0, R, (S,), generator=g, device=cuda).to(dtype)
    n0 = kernels.LAUNCHES["gather_rows"]
    got = gather_rows(table, rows)
    assert kernels.LAUNCHES["gather_rows"] == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, table[rows.long()])


_OUT_OF_RANGE = textwrap.dedent("""
    import sys
    import torch
    from edgegraph3d_tpu_torch.ops.gather import gather_rows
    table = torch.zeros((10, 8), device="cuda")
    gather_rows(table, torch.tensor({bad}, device="cuda",
                                    dtype=torch.{dtype}))
    try:
        torch.cuda.synchronize()
    except Exception as e:            # torch.AcceleratorError on 2.8+
        print("RAISED", e)
        sys.exit(3)
    print("NO ERROR")
""")


@pytest.mark.parametrize("bad,dtype", [([0, 10], "int64"), ([-1, 3], "int32")])
def test_gather_rows_out_of_range_raises(cuda, bad, dtype):
    """An index outside [0, R) fails the kernel's device-side assert, as
    table[rows] does on the card, reported at the next synchronise.  It
    runs in a child process: the assert poisons the CUDA context of the
    process it fires in."""
    kernels.lib()                           # build before the child runs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _OUT_OF_RANGE.format(bad=bad, dtype=dtype)],
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
    n0 = kernels.LAUNCHES["group_seed_sample"]
    got = polyline_stages.group_seed_sample(*args)
    assert kernels.LAUNCHES["group_seed_sample"] == n0 + 1
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


@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_expand_chains_kernel_matches_plain(scene, chains, mode):
    """K7 (one launch over every tile bucket) against its plain version
    (the view loop around K1 / K2 / K3) on the card: the same
    acceptances, out_xy and X bit-equal or within 1e-6 relative."""
    _, ctx = scene
    C, T, extent, tensors = chains
    cfg = ctx.config.replace(expand_correspondence_mode=mode)
    args = (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            *tensors, cfg, C, T)
    n0 = kernels.LAUNCHES["expand_chains"]
    Xk, xyk, okk = expansion.expand_chains_compact(*args, extent)
    assert kernels.LAUNCHES["expand_chains"] == n0 + 1
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


LENGTHS = (1, 2, 3, 8, 9, 16, 17, 32, 33, 64)


def _regrouped(chains):
    """The fixture's chain points, in chain order and cycled as often as
    needed, cut into new chains of every tile bucket's edge lengths
    (LENGTHS); each new chain takes the tuple views of its first point's
    chain."""
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


@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_expand_chains_every_tile_width(scene, chains, mode):
    """Chains of 1, 2, 3, 8, 9, 16, 17, 32, 33 and 64 points in one call
    (all four tile buckets, each at its edges): K7, in one launch,
    bit-equal to its plain version."""
    _, ctx = scene
    C, T, lens, tensors = _regrouped(chains)
    cfg = ctx.config.replace(expand_correspondence_mode=mode)
    args = (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            *tensors, cfg, C, T)
    ref = expansion._expand_chains_compact_plain(*args)
    n0 = kernels.LAUNCHES["expand_chains"]
    got = expansion.expand_chains_compact(*args, lens)
    assert kernels.LAUNCHES["expand_chains"] == n0 + 1
    torch.cuda.synchronize()
    assert ref[2].sum(1).max() > 3                 # views were added
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _k2_one_thread(grids, view, pts, lines, radius, cell, M,
                   exclude_parallel_cos=None):
    """K2's one-thread-per-query body (the one K7's "epipolar" mode runs),
    launched through the C entry as the wrapper launches its 8-lane body:
    the same view-major order and outputs."""
    grids, view, pts, lines, radius = (
        t.contiguous() for t in (grids, view, pts, lines, radius))
    V, GH, GW, Kc, _ = grids.shape
    Q = len(view)
    out = detection._empty_outputs(Q, M, pts.device)
    if Q == 0:
        return out
    use = exclude_parallel_cos is not None
    order = detection._view_major_order(view, V)
    rc = kernels.lib().eg3d_epipolar_topm(
        grids.data_ptr(), V, GH, GW, Kc, view.data_ptr(), pts.data_ptr(),
        lines.data_ptr(), radius.data_ptr(), order.data_ptr(), Q,
        float(cell), M, 1, int(use),
        float(exclude_parallel_cos) if use else 0.0,
        *detection._out_ptrs(out), kernels.stream_of(pts))
    kernels.check(rc, "epipolar_topm_query")
    return out


def test_expand_chains_epipolar_under_both_k2_bodies(scene, chains,
                                                     monkeypatch):
    """K7's "epipolar" mode runs K2's one-thread body per point; its
    plain version calls the K2 wrapper.  K7 equals the plain version with
    K2 in its 8-lane body (the wrapper) and in its one-thread body."""
    _, ctx = scene
    C, T, extent, tensors = chains
    cfg = ctx.config.replace(expand_correspondence_mode="epipolar")
    args = (ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
            *tensors, cfg, C, T)
    got = expansion.expand_chains_compact(*args, extent)
    for body in ("8 lanes", "one thread"):
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


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_epipolar_topm_bodies_and_orders(scene, M, ties):
    """K2's 8-lane body (the wrapper) and its one-thread body, on queries
    given start-major (every view of one start side by side, as the
    seeding issues them) and shuffled, with border queries (clamped
    cells) and, on a lattice grid, forced distance ties: identical to the
    plain version."""
    _, ctx = scene
    rng = np.random.default_rng(20 + M + ties)
    grids = ctx.grids
    if ties:
        V, GH, GW, _, _ = grids.shape
        grids = torch.as_tensor(_tie_grid(rng, V, GH, GW), device=ctx.device)
    V, GH, GW = grids.shape[:3]
    W, H = GW * ctx.cell, GH * ctx.cell
    S = 600
    starts = np.stack([rng.uniform(-8, W + 8, S),
                       rng.uniform(-8, H + 8, S)], 1)
    starts[:6] = [[0, 0], [W - 0.1, H - 0.1], [-4, H / 2], [W + 3, 5],
                  [W / 2, -6], [0.5, H + 2]]
    pts = np.repeat(starts, V, 0) + rng.normal(0, 3.0, (S * V, 2))
    if ties:
        pts = np.round(pts) + 0.5
    view = np.tile(np.arange(V), S).astype(np.int32)
    ang = rng.choice([0.0, np.pi / 2], S * V) if ties else \
        rng.uniform(0, np.pi, S * V)
    ab = np.stack([np.cos(ang), np.sin(ang)], 1).round(6)
    c = -(ab * pts).sum(1) + rng.integers(-3, 4, S * V)
    lines = np.concatenate([ab, c[:, None]], 1).astype(np.float32)
    radius = rng.uniform(3.0, 30.0, S * V).astype(np.float32)
    dev = ctx.device
    as_t = lambda a: torch.as_tensor(a, device=dev)
    a = (grids, as_t(view), as_t(pts.astype(np.float32)), as_t(lines),
         as_t(radius), ctx.cell, M)
    ref = detection._epipolar_topm_plain(*a)
    perm = as_t(rng.permutation(S * V))
    shuffled = (grids, *(t[perm] for t in a[1:5]), ctx.cell, M)
    for body in (detection.epipolar_topm_query, _k2_one_thread):
        got = body(*a)
        got_s = body(*shuffled)
        torch.cuda.synchronize()
        for x, y, z in zip(got, ref, got_s):
            assert torch.equal(x, y), body.__name__
            assert torch.equal(z, y[perm]), body.__name__
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
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.MAIN_PATH_KERNELS), \
        kernels.LAUNCHES
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
    n0 = kernels.LAUNCHES["ba_blocks"]
    got = ba.ba_blocks(state, *obs, damping=damping)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ba_blocks"] == n0 + 1
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
    assert kernels.LAUNCHES["ba_blocks"] == 2
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
