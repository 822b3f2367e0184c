"""Hand-written CUDA kernels (K1-K4) against their plain-torch twins.

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

import numpy as np
import pytest
import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import synthetic
from edgegraph3d_tpu_torch.matching import detection, following, refpoints
from edgegraph3d_tpu_torch.ops import triangulation
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


@pytest.mark.parametrize("M", [1, 2, 4])
def test_grid_topm_kernel_matches_plain(scene, M):
    _, ctx = scene
    view, pts = _queries(ctx, 20000, M)
    n0 = kernels.LAUNCHES["grid_topm_query"]
    got = detection.grid_topm_query(ctx.grids, view, pts, ctx.cell, 10.0, M)
    assert kernels.LAUNCHES["grid_topm_query"] == n0 + 1
    ref = detection._grid_topm_plain(ctx.grids, view, pts, ctx.cell, 10.0, M)
    torch.cuda.synchronize()
    assert ref.valid.any()
    _assert_same_candidates(got, ref)


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


@pytest.mark.parametrize("O,warm", [(2, False), (3, False), (3, True),
                                    (8, True), (8, False)])
def test_triangulate_gn_kernel_matches_plain(scene, O, warm):
    sfmd, ctx = scene
    rng = np.random.default_rng(O + 10 * warm)
    N = 8192
    V = ctx.P_mats.shape[0]
    X = sfmd.points[rng.integers(0, sfmd.n_points, N)] \
        + rng.normal(0, 0.01, (N, 3))
    cams = np.stack([rng.permutation(V)[:O] for _ in range(N)]) \
        .astype(np.int32)
    P = sfmd.P[cams]                                         # [N,O,3,4]
    Xh = np.concatenate([X, np.ones((N, 1))], 1)
    proj = np.einsum("noij,nj->noi", P, Xh)
    xy = proj[..., :2] / proj[..., 2:3] + rng.normal(0, 1.5, (N, O, 2))
    xy[rng.random(N) < 0.2, 0] += 25.0          # gross outliers: rejects
    mask = rng.random((N, O)) < 0.85
    dev = ctx.device
    args = (ctx.P_mats, torch.as_tensor(cams, device=dev),
            torch.as_tensor(xy.astype(np.float32), device=dev),
            torch.as_tensor(mask, device=dev))
    X0 = (torch.as_tensor((X + rng.normal(0, 0.02, X.shape))
                          .astype(np.float32), device=dev) if warm else None)
    kw = dict(X0=X0, max_iters=8 if warm else 30, accept_mse=9.0)
    Xk, msek, okk = triangulation.triangulate_gn(*args, **kw)
    Xp, msep, okp = triangulation._triangulate_gn_plain(
        *args, X0, kw["max_iters"], 5e-7, 9.0, 1e-5)
    torch.cuda.synchronize()
    assert okp.any() and not okp.all()
    assert torch.equal(okk, okp)
    torch.testing.assert_close(Xk[okp], Xp[okp], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(msek[okp], msep[okp], rtol=1e-4, atol=1e-6)


def test_follow_walk_kernel_matches_plain(scene):
    sfmd, ctx = scene
    obs_xy, obs_mask = refpoints.dense_observations(sfmd)
    dev = ctx.device
    seeds = refpoints.compute_seeds_chunk(
        ctx, torch.as_tensor(obs_xy, device=dev),
        torch.as_tensor(obs_mask, device=dev),
        torch.as_tensor(obs_mask, device=dev))
    S = len(seeds["cams"])
    assert S > 0
    rng = np.random.default_rng(0)
    dirs = torch.as_tensor(rng.choice([-1, 1], (S, 3)).astype(np.int32),
                           device=dev)
    args = (ctx.plg_coords, ctx.plg_length, ctx.F_table,
            seeds["cams"].to(torch.int32), seeds["pl_id"].to(torch.int32),
            seeds["seg"].to(torch.int32), seeds["t"], seeds["xy"], dirs,
            torch.ones(S, dtype=torch.bool, device=dev), 32, 10.0, 5.0,
            20.0, 0.965, 5.0)
    got = following.follow_walk(*args)
    ref = following._walk_plain(*args)
    torch.cuda.synchronize()
    assert ref.alive[:, 0].any()
    assert torch.equal(got.alive, ref.alive)
    live = ref.alive
    assert torch.equal(got.seg[live], ref.seg[live])
    torch.testing.assert_close(got.obs[live], ref.obs[live], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got.t[live], ref.t[live], rtol=0, atol=1e-6)


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
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    cpu = refpoints.reconstruct_from_refpoints(sfmd, cpu_ctx,
                                               max_starting_views=2)
    assert len(gpu.X) == len(cpu.X) > 0
    np.testing.assert_array_equal(gpu.obs_mask, cpu.obs_mask)
    np.testing.assert_allclose(gpu.X, cpu.X, rtol=0, atol=1e-4)
