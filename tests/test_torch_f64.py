"""EdgeGraphConfig(dtype="float64") in the port against the JAX package
under x64 (jax_enable_x64), on the CPU.

x64 is a process-wide switch of JAX, so the whole JAX reference is built
in ONE subprocess per module (`python tests/test_torch_f64.py --reference
OUT.npz`, the `reference` fixture):

  * tools/f64_probe.py's scene and configuration, stage 3 through
    refpoints.build_context / reconstruct_from_refpoints, as the probe
    runs them (the probe's own output fields);
  * run_pipeline(stages=(3,)) on test_torch_pipeline.py's cube scene;
  * the x64 context of the probe scene (grids, F, P) with K1's, K2's and
    K3's JAX functions on seeded queries over it;
  * that run_pipeline(stages=(1,)) raises there (a TypeError of the
    group-seed sweep's f32 scan carry, ops/polyline_ops.py:294).

Tolerances.  Decisions (seed ids, chain orders, observation masks, view
lists, candidate ids) must be equal.  f64 coordinates are held within
1e-9 scene units / px (run_pipeline's output points, which the f32 GN
filter re-refines, within 1e-6): the port reproduces JAX's x64 arithmetic
operation by operation, the walk's fused multiply-adds included
(ops.geometry._fma, correctly rounded in f64), and the measured
differences are at the last bit (5.6e-16 in X on the probe scene; 0 in
the image coordinates), so 1e-9 leaves room for a reordered sum but not
for an f32 rounding (~1e-7 relative) anywhere on the path.  The port's
f32 run against its f64 run is held as tests/test_f64_parity.py holds
JAX's: the same accepted sets, X within 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:          # run as a script (the reference mode)
    sys.path.insert(0, REPO)

from edgegraph3d_tpu_torch import kernels  # noqa: E402
from edgegraph3d_tpu_torch import pipeline as tp  # noqa: E402
from edgegraph3d_tpu_torch.config import \
    EdgeGraphConfig as TConfig  # noqa: E402
from edgegraph3d_tpu_torch.core import synthetic  # noqa: E402
from edgegraph3d_tpu_torch.matching import (  # noqa: E402
    detection, expansion, following)
from edgegraph3d_tpu_torch.matching import matches as t_mm  # noqa: E402
from edgegraph3d_tpu_torch.matching import refpoints as t_rp  # noqa: E402
from edgegraph3d_tpu_torch.ops import (  # noqa: E402
    gather, geometry, triangulation)
from edgegraph3d_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from edgegraph3d_tpu_torch.plgs.extraction import \
    extract_plgs  # noqa: E402

#: tools/f64_probe.py's configuration
PROBE_KW = dict(max_polylines_per_view=256, max_polyline_len=128,
                max_follow_steps=64)
#: test_torch_pipeline.py's
CUBE_KW = dict(max_polylines_per_view=256, max_polyline_len=128,
               max_follow_steps=64)
TOL = 1e-9


def probe_scene(syn=synthetic):
    return syn.make_scene(n_cams=8, n_refpoints_per_curve=12, width=320,
                          height_px=240, focal=400.0, seed=3)


def cube_scene(syn=synthetic):
    return syn.make_cube_scene(n_cams=8, n_refpoints_per_edge=8, width=320,
                               height_px=240, focal=400.0, seed=7)


def query_inputs(V: int, H: int, W: int):
    """Seeded module-level queries: f64 points on every view, f64 unit
    lines through them, f32 radii, and the rows of a 3-view GN."""
    rng = np.random.default_rng(5)
    Q = 512
    view = rng.integers(0, V, Q).astype(np.int32)
    pts = np.stack([rng.uniform(0, W, Q), rng.uniform(0, H, Q)], -1)
    ang = rng.uniform(0, np.pi, Q)
    n = np.stack([np.cos(ang), np.sin(ang)], -1)
    lines = np.concatenate([n, -(n * pts).sum(1, keepdims=True)], 1)
    radius = rng.uniform(3.0, 30.0, Q).astype(np.float32)
    return view, pts, lines, radius


# ----------------------------------------------------------------------
# the JAX x64 reference (subprocess)
# ----------------------------------------------------------------------

def build_reference(out: str) -> None:
    """Everything the tests compare against, in one x64 process."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.core import synthetic as j_syn
    from edgegraph3d_tpu.matching import detection as j_det
    from edgegraph3d_tpu.matching import matches as j_mm
    from edgegraph3d_tpu.matching import refpoints as j_rp
    from edgegraph3d_tpu.ops import triangulation as j_tri
    from edgegraph3d_tpu.pipeline import run_pipeline
    from edgegraph3d_tpu.plgs import extraction as j_ext

    res = {}
    cfg = EdgeGraphConfig().replace(dtype="float64", **PROBE_KW)
    sfmd, edges, _ = probe_scene(j_syn)
    stack = j_ext.extract_plgs(edges, cfg)
    ctx = j_rp.build_context(sfmd, stack, cfg, cell=10.0)
    pts = j_rp.reconstruct_from_refpoints(
        sfmd, ctx, refpoint_chunk=64, seed_chunk=512, max_starting_views=2,
        manager=j_mm.MatchesManager(np.asarray(ctx.plg_length)))
    for k in ("X", "obs_mask", "obs_xy", "seed_id", "chain_order"):
        res["probe_" + k] = np.asarray(getattr(pts, k))
    for k in ("plg_coords", "plg_length", "grids", "P_mats", "F_table"):
        res["ctx_" + k] = np.asarray(getattr(ctx, k))

    # K1 (f64 points), K2 (f64 lines, f32 points) and K3 (O = 3, f64)
    grids, cell = ctx.grids, ctx.cell
    V, GH, GW = grids.shape[:3]
    view, q, lines, radius = query_inputs(V, GH * cell, GW * cell)
    k1 = jax.jit(jax.vmap(lambda v, p: j_det.detect_starting_intersections(
        grids[v], p, cell, 10.0, 4)))(jnp.asarray(view), jnp.asarray(q))
    k2 = jax.jit(jax.vmap(
        lambda v, p, ln, r: j_det.detect_epipolar_correspondences(
            grids[v], p, ln, cell, r, 4)))(
        jnp.asarray(view), jnp.asarray(q.astype(np.float32)),
        jnp.asarray(lines), jnp.asarray(radius))
    for name, cands in (("k1", k1), ("k2", k2)):
        for f in ("pl_id", "seg", "t", "xy", "dist", "valid"):
            res[f"{name}_{f}"] = np.asarray(getattr(cands, f))
    cams, xy = gn_rows(np.asarray(ctx.P_mats), sfmd.points)
    P3 = ctx.P_mats[jnp.asarray(cams)]
    mask = jnp.ones(cams.shape, bool)
    X0 = j_tri.triangulate_dlt(P3, jnp.asarray(xy), mask)
    X, mse, ok = j_tri.gauss_newton_batched(P3, jnp.asarray(xy), mask, X0)
    res.update(k3_X=np.asarray(X), k3_mse=np.asarray(mse),
               k3_valid=np.asarray(ok))

    sfmd, edges, _ = cube_scene(j_syn)
    out_c = run_pipeline(sfmd, edges, EdgeGraphConfig().replace(
        dtype="float64", **CUBE_KW), max_starting_views=2, stages=(3,))
    n0 = sfmd.n_points
    res.update(cube_n0=n0, cube_points=np.asarray(out_c.points),
               cube_obs_len=np.asarray([len(c) for c in out_c.obs_cam]),
               cube_obs_cam=np.concatenate(
                   [np.asarray(c, np.int64) for c in out_c.obs_cam]))
    try:
        run_pipeline(sfmd, edges, EdgeGraphConfig().replace(
            dtype="float64", **CUBE_KW), max_starting_views=2, stages=(1,))
        res["stage1_error"] = "none"
    except Exception as e:   # the failure the port's refusal names
        res["stage1_error"] = f"{type(e).__name__}: {e}"[:2000]
    np.savez(out, **res)


def gn_rows(P_mats: np.ndarray, points: np.ndarray):
    """3-view GN rows from a seed: scene points through three random
    cameras with 0.5 px noise (f64), a fifth with a gross outlier."""
    rng = np.random.default_rng(9)
    n, V = 400, len(P_mats)
    X = points[rng.integers(0, len(points), n)]
    cams = np.stack([rng.permutation(V)[:3] for _ in range(n)]).astype(
        np.int32)
    Ph = P_mats[cams]                                         # [n,3,3,4]
    pr = (Ph[..., :3] * X[:, None, None, :]).sum(-1) + Ph[..., 3]
    xy = pr[..., :2] / pr[..., 2:3] + rng.normal(0, 0.5, (n, 3, 2))
    xy[rng.random(n) < 0.2, 0, 0] += 25.0
    return cams, xy


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    from test_torch_native import require_jax_native_lib
    require_jax_native_lib()
    out = str(tmp_path_factory.mktemp("f64") / "reference.npz")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--reference", out], capture_output=True,
                       timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    return dict(np.load(out))


# ----------------------------------------------------------------------
# the port's runs
# ----------------------------------------------------------------------

def port_probe(dtype: str):
    cfg = TConfig().replace(dtype=dtype, **PROBE_KW)
    sfmd, edges, _ = probe_scene()
    ctx = t_rp.build_context(sfmd, extract_plgs(edges, cfg), cfg, cell=10.0,
                             device="cpu")
    return t_rp.reconstruct_from_refpoints(
        sfmd, ctx, refpoint_chunk=64, seed_chunk=512, max_starting_views=2,
        manager=t_mm.MatchesManager(ctx.plg_length.numpy()))


@pytest.fixture(scope="module")
def probe64():
    return port_probe("float64")


@pytest.fixture(scope="module")
def cube():
    return cube_scene()


def run_cube(cube, stages=(3,), mesh=None, dtype="float64"):
    sfmd, edges, _ = cube
    return tp.run_pipeline(sfmd, edges, TConfig().replace(
        dtype=dtype, **CUBE_KW), max_starting_views=2, stages=stages,
        mesh=mesh, device="cpu")


@pytest.fixture(scope="module")
def cube64(cube):
    return run_cube(cube)


def obs_lists(scene, n0):
    return [c.tolist() for c in scene.obs_cam[n0:]]


# ----------------------------------------------------------------------
# the slice against JAX x64
# ----------------------------------------------------------------------

def test_stage3_matches_jax_x64_on_the_probe_scene(reference, probe64):
    """reconstruct_from_refpoints in f64 (build_context from the port's
    own extraction and F table) against tools/f64_probe.py --x64."""
    r = {k[6:]: v for k, v in reference.items() if k.startswith("probe_")}
    for k in ("seed_id", "chain_order", "obs_mask"):
        np.testing.assert_array_equal(getattr(probe64, k), r[k], err_msg=k)
    assert r["obs_mask"].sum() > 100
    assert probe64.X.dtype == np.float64
    np.testing.assert_allclose(probe64.X, r["X"], rtol=0, atol=TOL)
    np.testing.assert_allclose(probe64.obs_xy[r["obs_mask"]],
                               r["obs_xy"][r["obs_mask"]], rtol=0, atol=1e-3)


def test_pipeline_matches_jax_x64_on_the_cube(reference, cube64):
    """run_pipeline(stages=(3,)) in f64: seeding, following, expansion,
    extension, the density filter and the GN filter (f32, as in JAX)."""
    n0 = int(reference["cube_n0"])
    ends = np.cumsum(reference["cube_obs_len"])
    j_lists = [c.tolist() for c in np.split(reference["cube_obs_cam"],
                                            ends[:-1])][n0:]
    assert cube64.n_points == len(reference["cube_points"]) > n0 + 100
    assert obs_lists(cube64, n0) == j_lists
    # the output points come out of the GN filter, which refines in f32
    # in both packages, where the port's f32 GN and XLA's round apart
    # (measured 2.4e-7 at the cube's scale of 0.6)
    np.testing.assert_allclose(cube64.points, reference["cube_points"],
                               rtol=0, atol=1e-6)


def test_f32_and_f64_runs_accept_the_same(probe64):
    """tests/test_f64_parity.py's claim for the port: f32 and f64 accept
    the same seeds, chain orders and observation masks."""
    p32 = port_probe("float32")
    for k in ("seed_id", "chain_order", "obs_mask"):
        np.testing.assert_array_equal(getattr(p32, k), getattr(probe64, k),
                                      err_msg=k)
    np.testing.assert_allclose(p32.X, probe64.X, rtol=0, atol=1e-4)


def test_mesh_f64_equals_the_single_device_run(cube, cube64):
    """Stage 3 in f64 on 3 CPU shards: the same scene, bit for bit."""
    out = run_cube(cube, mesh=t_mesh.make_mesh(devices=["cpu"] * 3))
    assert out.n_points == cube64.n_points
    n0 = cube[0].n_points
    assert obs_lists(out, n0) == obs_lists(cube64, n0)
    np.testing.assert_array_equal(out.points, cube64.points)


def test_unknown_stage_is_ignored(cube, cube64):
    """stages=(3, 7) runs stage 3 alone, as the JAX package's `k in
    stages` tests do."""
    out = run_cube(cube, stages=(3, 7))
    np.testing.assert_array_equal(out.points, cube64.points)
    n0 = cube[0].n_points
    assert obs_lists(out, n0) == obs_lists(cube64, n0)


@pytest.mark.parametrize("stages", [(1,), (2,), (1, 2, 3), (2, 3)])
def test_float64_refuses_stages_1_and_2(reference, cube, monkeypatch,
                                        stages):
    """JAX fails in stage 1's sweep under x64; the port refuses before
    any work (no extraction)."""
    err = str(reference["stage1_error"])
    assert err.startswith("TypeError") and "carry[0].t" in err, err
    monkeypatch.setattr(tp, "extract_plgs", lambda *a: pytest.fail(
        "work started before the refusal"))
    with pytest.raises(NotImplementedError, match="polyline_ops.py:294"):
        run_cube(cube, stages=stages)


# ----------------------------------------------------------------------
# the kernels' modules against JAX x64, and no narrowing
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx64(reference):
    """The port's context built from JAX's x64 arrays."""
    return t_rp.context_from_arrays(
        *(reference["ctx_" + k] for k in ("plg_coords", "plg_length",
                                           "grids", "P_mats", "F_table")),
        10.0, TConfig().replace(dtype="float64"), device="cpu")


def same_candidates(got, reference, name):
    for f in ("pl_id", "seg", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      reference[f"{name}_{f}"], err_msg=f)
    for f in ("t", "xy", "dist"):
        assert getattr(got, f).dtype == torch.float64, f
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   reference[f"{name}_{f}"], rtol=0,
                                   atol=TOL, err_msg=f)


def test_k1_f64_points_match_jax(reference, ctx64):
    V, GH, GW = ctx64.grids.shape[:3]
    view, q, _, _ = query_inputs(V, GH * 10.0, GW * 10.0)
    got = detection.grid_topm_query(ctx64.grids, torch.as_tensor(view),
                                    torch.as_tensor(q), 10.0, 10.0, 4)
    assert reference["k1_valid"].any()
    same_candidates(got, reference, "k1")


def test_k2_f64_lines_match_jax(reference, ctx64):
    V, GH, GW = ctx64.grids.shape[:3]
    view, q, lines, radius = query_inputs(V, GH * 10.0, GW * 10.0)
    got = detection.epipolar_topm_query(
        ctx64.grids, torch.as_tensor(view),
        torch.as_tensor(q.astype(np.float32)), torch.as_tensor(lines),
        torch.as_tensor(radius), 10.0, 4)
    assert reference["k2_valid"].any()
    same_candidates(got, reference, "k2")


def test_k3_f64_matches_jax(reference, ctx64):
    cams, xy = gn_rows(ctx64.P_mats.numpy(), probe_scene()[0].points)
    X, mse, ok = triangulation.triangulate_gn(
        ctx64.P_mats, torch.as_tensor(cams), torch.as_tensor(xy),
        torch.ones(cams.shape, dtype=torch.bool))
    np.testing.assert_array_equal(ok.numpy(), reference["k3_valid"])
    assert 0 < reference["k3_valid"].sum() < len(cams)
    assert X.dtype == mse.dtype == torch.float64
    np.testing.assert_allclose(X.numpy(), reference["k3_X"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(mse.numpy(), reference["k3_mse"], rtol=1e-9)


def _k4_case(ctx):
    """One follow_walk call on seeds of the probe scene's refpoints."""
    sfmd = probe_scene()[0]
    obs_xy, obs_mask = t_rp.dense_observations(sfmd)
    ox, om = torch.as_tensor(obs_xy[:64]), torch.as_tensor(obs_mask[:64])
    starts = t_rp._start_sweep(ctx, ox, om, 10.0, 4)
    st = t_rp._seed_tuple(t_rp._seed_from_starts(ctx, starts, ox, om, 4))
    dirs = torch.tensor([[1, 1, 1]], dtype=torch.int32).expand(
        len(st.cams), 3).contiguous()
    return following.follow_walk(
        ctx.plg_coords, ctx.plg_length, ctx.F_table, ctx.P_mats, st.cams,
        st.pl_id, st.seg, st.t, st.xy, dirs, st.valid, None, 8, ctx.config)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K7"])
def test_wrappers_never_narrow_f64(ctx64, kernel):
    """Each wrapper handed f64 geometry returns f64; f32 beside f64 is
    widened where JAX promotes it, and K1 with f32 points (the seeding's
    starts) stays f32."""
    g, P, F = ctx64.grids, ctx64.P_mats, ctx64.F_table
    view = torch.zeros(4, dtype=torch.int32)
    pts = torch.tensor([[40.0, 50.0], [100.0, 80.0], [200.0, 120.0],
                        [10.0, 10.0]], dtype=torch.float64)
    if kernel == "K1":
        assert detection.grid_topm_query(g, view, pts, 10.0, 10.0, 2) \
            .xy.dtype == torch.float64
        assert detection.grid_topm_query(g, view, pts.float(), 10.0, 10.0,
                                         2).xy.dtype == torch.float32
    elif kernel == "K2":
        lines = geometry.epipolar_line(F[1, 0][None], pts.float()[:, None]
                                       )[:, 0]
        assert lines.dtype == torch.float64
        c = detection.epipolar_topm_query(g, view, pts.float(), lines,
                                          torch.full((4,), 9.0), 10.0, 2)
        assert c.t.dtype == c.xy.dtype == c.dist.dtype == torch.float64
    elif kernel == "K3":
        cams = torch.tensor([[0, 1, 2]] * 4, dtype=torch.int32)
        X, mse, _ = triangulation.triangulate_gn(
            P, cams, torch.rand(4, 3, 2) * 100, torch.ones(4, 3, dtype=bool),
            X0=torch.zeros(4, 3))
        assert X.dtype == mse.dtype == torch.float64
    elif kernel == "K4":
        f = _k4_case(ctx64)
        assert f.X.dtype == f.obs.dtype == f.t.dtype == torch.float64
        assert f.valid.any()
    elif kernel == "K5":
        table = ctx64.plg_coords.reshape(-1, 2 * ctx64.plg_coords.shape[2])
        assert gather.gather_rows(table, torch.tensor([0, 3])).dtype \
            == torch.float64
    else:
        X = torch.tensor([[0.1, 0.2, 0.3]], dtype=torch.float32)
        Xr, out_xy, _ = expansion.expand_chains_compact(
            ctx64.plg_coords, g, P, F, 10.0, X, torch.zeros(1, 3, 2),
            torch.tensor([[0, 1, 2]], dtype=torch.int32),
            torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=bool),
            torch.ones(1, 1, dtype=bool), ctx64.config, 1, 1,
            extent=np.ones(1, np.int64))
        assert Xr.dtype == out_xy.dtype == torch.float64


def test_fma64_is_correctly_rounded():
    """ops.geometry._fma in f64 against the exact a * b + c, rounded
    once: random operands at the walk's scales, cancellations and exact
    ties (the hardware fma XLA's CPU code and the f64 kernels use)."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    n = 3000
    a = rng.uniform(-2e3, 2e3, n)
    b = rng.uniform(-2e3, 2e3, n)
    c = np.concatenate([rng.uniform(-4e6, 4e6, n // 2),
                        -(a * b)[n // 2:] * (1 + rng.uniform(-1e-12, 1e-12,
                                                             n - n // 2))])
    a = np.concatenate([a, [1 + 2 ** -30, 3.0, 1.0, 1 + 2 ** -52]])
    b = np.concatenate([b, [1 + 2 ** -30, 2 ** -53, 2 ** -53, 2 ** -53]])
    c = np.concatenate([c, [0.0, 1.0, 1.0, 1.0]])
    got = geometry._fma(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, want)


def test_launch_counts_split_by_dtype():
    kernels.reset_launch_counts()
    kernels.count_launch("gather_rows", torch.float64)
    kernels.count_launch("gather_rows", torch.float32)
    assert kernels.launch_totals()["gather_rows"] == 2
    assert kernels.LAUNCHES["gather_rows"] == {"float32": 1, "float64": 1}
    kernels.reset_launch_counts()
    assert kernels.LAUNCHES["gather_rows"]["float64"] == 0
    with pytest.raises(TypeError):
        kernels.require_float(torch.float16, "gather_rows")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        build_reference(sys.argv[2])
    else:
        sys.exit("usage: python tests/test_torch_f64.py --reference OUT.npz")
