"""Joint bundle adjustment: the port's ops/ba.py (plain torch on the CPU,
K8's plain version) against the JAX package's ops/ba.py, and the
pipeline's joint-BA stage against JAX's.

Tolerances (f32; the port sums the blocks in another order than JAX's
one-hot einsums, so nothing is compared bit for bit):
  * exp_so3 within 1e-6 of JAX's;
  * the analytic Jacobians against torch.func.jacfwd of the port's own
    residual, in float64, within 1e-9 relative (they are the same
    derivatives, so only rounding differs);
  * the blocks, the Schur complement and its right-hand side within
    2e-5 of each array's largest magnitude (measured ~1e-6);
  * after 1 and 6 LM steps: cameras within atol 1e-5 and points within
    atol 1e-4, the bounds tests/test_ba.py uses between its own two
    paths;
  * the pipeline: the same kept points with the same view lists as
    JAX's after BA and the filter, points within 1e-4, the joint-BA
    metrics within 1e-4 relative;
  * K8's view-major observation index exactly, and a numpy model of
    K8's reduction order within 1e-5 of each array's largest magnitude
    of the plain version's and JAX's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from edgegraph3d_tpu import pipeline as jpipe
from edgegraph3d_tpu.cli import edge_graph_3d as j_cli
from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import sfm as j_sfm
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.ops import ba as jba
from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.cli import edge_graph_3d as t_cli
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.core import sfm as t_sfm
from edgegraph3d_tpu_torch.ops import ba as tba
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_ba.py's scene: points and poses perturbed."""
    sfmd, _, _ = synthetic.make_scene(n_cams=8, n_refpoints_per_curve=16,
                                      width=320, height_px=240,
                                      focal=400.0, seed=5)
    rng = np.random.default_rng(0)
    X0 = sfmd.points + rng.normal(0, 0.01, sfmd.points.shape)
    w = rng.normal(0, 0.002, (sfmd.n_cameras, 3))
    R0 = np.asarray(jba.exp_so3(jnp.asarray(w))) @ sfmd.R
    t0 = sfmd.t + rng.normal(0, 0.005, sfmd.t.shape)
    arrays = [np.asarray(a, np.float32) for a in (sfmd.K, R0, t0, X0)]
    return sfmd, arrays


def _observations(sfmd, layout):
    """(cam, xy, mask) as [N, O] arrays: "dense" (O = V, cam = arange),
    or "packed": each point's views shuffled and cut to at most 5, plus
    a duplicate of its first observation in slot 5 on every third row
    (O = 6 < V)."""
    N, V = sfmd.n_points, sfmd.n_cameras
    if layout == "dense":
        xy = np.zeros((N, V, 2), np.float32)
        mask = np.zeros((N, V), bool)
        for n in range(N):
            xy[n, sfmd.obs_cam[n]] = sfmd.obs_xy[n]
            mask[n, sfmd.obs_cam[n]] = True
        return np.tile(np.arange(V, dtype=np.int32), (N, 1)), xy, mask
    rng = np.random.default_rng(1)
    O = 6
    cam = np.full((N, O), -1, np.int32)
    xy = np.zeros((N, O, 2), np.float32)
    mask = np.zeros((N, O), bool)
    for n in range(N):
        order = rng.permutation(len(sfmd.obs_cam[n]))[:5]
        k = len(order)
        cam[n, :k] = sfmd.obs_cam[n][order]
        xy[n, :k] = sfmd.obs_xy[n][order]
        mask[n, :k] = True
        if n % 3 == 0:
            cam[n, 5], xy[n, 5], mask[n, 5] = cam[n, 0], xy[n, 0], True
    return cam, xy, mask


def _states(arrays):
    return (jba.BAState(*(jnp.asarray(a) for a in arrays)),
            tba.BAState(*(torch.as_tensor(a) for a in arrays)))


def test_exp_so3_matches_jax():
    """Both branches: th^2 >= 1e-8 (Rodrigues) and below (Taylor), and
    w = 0 exactly."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(0, 0.3, (40, 3)),
                        rng.normal(0, 2e-5, (40, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    assert ((w ** 2).sum(1) < 1e-8).sum() > 30
    got = tba.exp_so3(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jba.exp_so3(jnp.asarray(w))),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[-1], np.eye(3, dtype=np.float32))


def test_analytic_jacobians_match_jacfwd():
    """d proj / d(w, u) and d proj / dX at dpose = 0 against
    torch.func.jacfwd of the residual (negated), on random cameras and
    points, with the last point at depth 0 (|p_z| < 1e-9: the depth is
    the constant 1e-9 there)."""
    rng = np.random.default_rng(2)
    B = 24
    K = np.tile(np.array([[400.0, 0.3, 160.0], [0.0, 410.0, 120.0],
                          [0.0, 0.0, 1.0]]), (B, 1, 1))
    w = rng.normal(0, 0.5, (B, 3))
    R = tba.exp_so3(torch.as_tensor(w)).numpy()
    t = rng.normal(0, 0.3, (B, 3)) + [0.0, 0.0, 4.0]
    X = rng.normal(0, 0.5, (B, 3))
    q = np.array([0.7, -0.4, 0.0])
    X[-1] = R[-1].T @ (q - t[-1])
    xy = rng.uniform(0, 320, (B, 2))
    args = [torch.as_tensor(a, dtype=torch.float64)
            for a in (K, R, t, X, xy)]
    p_z = (args[1][-1] @ args[3][-1] + args[2][-1])[2]
    assert abs(float(p_z)) < 1e-9
    r, Jc, Jx = tba._residual_jacobians(*args)

    def res(K_, R_, t_, d_, X_, xy_):
        return tba._residual_one(K_, R_, t_, d_, X_, xy_)

    zero = torch.zeros((B, 6), dtype=torch.float64)
    jac = torch.func.vmap(torch.func.jacfwd(res, argnums=(3, 4)))(
        args[0], args[1], args[2], zero, args[3], args[4])
    r_ref = res(args[0], args[1], args[2], zero, args[3], args[4])
    assert _rel(r, r_ref) < 1e-12
    for got, ref in ((Jc, -jac[0]), (Jx, -jac[1])):
        for b in range(B):
            assert _rel(got[b], ref[b]) < 1e-9, b
    assert float(Jx[-1].abs().max()) > 1e10     # 1 / 1e-9 depth


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_blocks_and_schur_match_jax(ba_problem, layout):
    sfmd, arrays = ba_problem
    js, ts = _states(arrays)
    cam, xy, mask = _observations(sfmd, layout)
    V = sfmd.n_cameras
    if layout == "packed":
        assert cam.shape[1] < V and mask.sum() < sfmd.n_points * V
    jargs = (jnp.asarray(cam), jnp.asarray(xy), jnp.asarray(mask))
    targs = (torch.as_tensor(cam), torch.as_tensor(xy),
             torch.as_tensor(mask))
    r_j, Hxx_j, gx_j, Hxc_j, Hcc_j, gc_j, onehot = jba.ba_build_blocks(
        js, *jargs)
    r_t, Hxx_t, gx_t, Hxc_t, Hcc_t, gc_t = tba.ba_build_blocks(ts, *targs)
    for got, ref in ((r_t, r_j), (Hxx_t, Hxx_j), (gx_t, gx_j),
                     (Hxc_t, Hxc_j), (Hcc_t, Hcc_j), (gc_t, gc_j)):
        assert _rel(got, ref) < 2e-5
    S_j, rhs_j, Hinv_j, gx_j, Hxc_j, onehot, rsq_j, n_j = \
        jba.ba_schur_local(js, *jargs)
    S_t, blocks = tba.ba_schur_local(ts, *targs)
    S_j = np.asarray(S_j).transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
    B_j = np.einsum("nov,noij->nivj", np.asarray(onehot),
                    np.asarray(Hxc_j))
    assert S_t.shape == (6 * V, 6 * V)
    for got, ref in ((S_t, S_j), (blocks.rhs, rhs_j),
                     (blocks.Hxx_inv, Hinv_j), (blocks.gx, gx_j),
                     (blocks.B, B_j)):
        assert _rel(got, ref) < 2e-5
    np.testing.assert_allclose(float(blocks.resid_sq), float(rsq_j),
                               rtol=1e-5)
    assert int(blocks.n_obs) == int(n_j) == mask.sum()
    # A is B^T Hxx^-1 in the [V, 6, N, 3] layout the product reads
    A_ref = np.einsum("nkvi,nkl->vinl", blocks.B.numpy(),
                      blocks.Hxx_inv.numpy())
    assert _rel(blocks.A, A_ref) < 1e-6


@pytest.mark.parametrize("n_steps", [1, 6])
def test_ba_run_matches_jax(ba_problem, n_steps):
    sfmd, arrays = ba_problem
    js, ts = _states(arrays)
    cam, xy, mask = _observations(sfmd, "packed")
    st_j, mse_j = jba.ba_run(js, jnp.asarray(cam), jnp.asarray(xy),
                             jnp.asarray(mask), n_steps)
    st_t, mse_t = tba.ba_run(ts, torch.as_tensor(cam), torch.as_tensor(xy),
                             torch.as_tensor(mask), n_steps)
    assert mse_t.shape == (n_steps,)
    np.testing.assert_allclose(st_t.R.numpy(), np.asarray(st_j.R), atol=1e-5)
    np.testing.assert_allclose(st_t.t.numpy(), np.asarray(st_j.t), atol=1e-5)
    np.testing.assert_allclose(st_t.X.numpy(), np.asarray(st_j.X), atol=1e-4)
    np.testing.assert_allclose(mse_t[0].item(), float(mse_j[0]), rtol=1e-5)


def test_mse_falls_100x_in_8_steps(ba_problem):
    sfmd, arrays = ba_problem
    _, ts = _states(arrays)
    args = [torch.as_tensor(a) for a in _observations(sfmd, "dense")]
    mse0 = float(tba.ba_mse(ts, *args))
    st, mses = tba.ba_run(ts, *args, 8)
    assert mse0 > 0.1 and mses[0].item() == pytest.approx(mse0, rel=1e-6)
    assert float(tba.ba_mse(st, *args)) < mse0 * 1e-2


def test_joint_ba_refine_matches_jax(ba_problem):
    """The pipeline's BA stage on a scene whose points and poses are
    perturbed: refined R, t, centers and points, and both MSEs."""
    sfmd, arrays = ba_problem
    _, R0, t0, X0 = arrays
    scene = sfmd.copy()
    scene.R, scene.t = R0.astype(np.float64), t0.astype(np.float64)
    scene.points = X0.astype(np.float64)
    j, j0, j1 = jpipe.joint_ba_refine(scene, 3)
    t, t0_, t1 = tp.joint_ba_refine(scene, 3, device="cpu")
    assert t.R.dtype == np.float64 and t.t.dtype == np.float64
    np.testing.assert_allclose(t.R, j.R, atol=1e-5)
    np.testing.assert_allclose(t.t, j.t, atol=1e-5)
    np.testing.assert_allclose(t.center, j.center, atol=1e-4)
    np.testing.assert_allclose(t.points, j.points, atol=1e-4)
    np.testing.assert_allclose(t.center, -np.einsum("vji,vj->vi", t.R, t.t))
    np.testing.assert_allclose([t0_, t1], [j0, j1], rtol=1e-4, atol=1e-9)
    assert t1 < t0_ * 1e-2
    assert tp.joint_ba_refine(scene, 0, device="cpu") == (scene, None, None)


@pytest.fixture(scope="module")
def cube():
    require_jax_native_lib()
    return synthetic.make_cube_scene(n_cams=8, n_refpoints_per_edge=8,
                                     width=320, height_px=240, focal=400.0,
                                     seed=7)


def test_pipeline_ba_steps_matches_jax(cube):
    """run_pipeline(ba_steps=2), default stages, on the cube: BA between
    before_filtering.json and the outlier filter, the same kept points
    and view lists as JAX's, and the joint_ba metrics."""
    sfmd, imgs, _ = cube
    js = jpipe.PipelineStats()
    j = jpipe.run_pipeline(sfmd, imgs, EdgeGraphConfig().replace(
        ba_steps=2, **KW), max_starting_views=2, stats=js)
    ts = tp.PipelineStats()
    t = tp.run_pipeline(sfmd, imgs, TConfig().replace(ba_steps=2, **KW),
                        max_starting_views=2, stats=ts, device="cpu")
    n0 = sfmd.n_points
    assert t.n_points == j.n_points > n0 + 20
    assert [c.tolist() for c in t.obs_cam] == [c.tolist() for c in j.obs_cam]
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.R, j.R, rtol=0, atol=1e-5)
    assert ts.counts["joint_ba"] == 2
    for k in ("ba_mse_before", "ba_mse_after"):
        np.testing.assert_allclose(ts.metrics[k], js.metrics[k], rtol=1e-4)
    assert ts.metrics["ba_mse_after"] < ts.metrics["ba_mse_before"]


def test_edge_cli_ba_steps_matches_jax(cube, tmp_path):
    """`--ba-steps 2` through both command lines: the same points and
    observation keys, coordinates within 1e-4, refined poses within
    1e-5 (rotations) and 1e-4 (centers)."""
    sfmd, imgs, _ = cube
    for d in ("edges", "imgs"):
        (tmp_path / d).mkdir()
    for v in range(imgs.shape[0]):
        Image.fromarray(imgs[v]).save(
            tmp_path / "edges" / f"synthetic_{v:04d}.png")
    j_sfm.write_sfm_data(sfmd, str(tmp_path / "input.json"))
    args = lambda tag: [str(tmp_path / "imgs"), str(tmp_path / "edges"),
                        str(tmp_path / f"work_{tag}"),
                        str(tmp_path / "input.json"),
                        str(tmp_path / f"out_{tag}.json"),
                        "--max-starting-views", "2", "--ba-steps", "2"]
    assert j_cli.main(args("jax")) == 0
    assert t_cli.main(args("torch") + ["--device", "cpu"]) == 0
    a = t_sfm.read_sfm_data(str(tmp_path / "out_torch.json"))
    b = j_sfm.read_sfm_data(str(tmp_path / "out_jax.json"))
    assert a.n_points == b.n_points > sfmd.n_points
    assert [c.tolist() for c in a.obs_cam] == [c.tolist() for c in b.obs_cam]
    np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.center, b.center, rtol=0, atol=1e-4)
    assert np.abs(a.R - sfmd.R).max() > 0
    stats = json.loads((tmp_path / "work_torch" / "stats.json").read_text())
    assert stats["counts"]["joint_ba"] == 2
    assert "ba_mse_after" in stats["metrics"]


# ----------------------------------------------------------------------
# K8's view-major observation index and a numpy model of its reductions
# ----------------------------------------------------------------------

def _index_cases():
    """(cam, mask, V) layouts: dense at V = 1, 33, 65; the random packed
    layout (O != V, a duplicate on every third row, masked -1 slots); a
    present slot with cam -1 (clamped to camera 0, as everywhere in BA);
    N = 0; nothing present."""
    from test_torch_cuda_kernels import random_ba_problem
    cases = {}
    for V in (1, 33, 65):
        _, (cam, _, mask) = random_ba_problem(V, 97, "dense", seed=V)
        cases[f"dense-V{V}"] = (cam, mask, V)
    _, (cam, _, mask) = random_ba_problem(33, 97, "packed")
    cases["packed-V33"] = (cam, mask, 33)
    cam2, mask2 = cam.copy(), mask.copy()
    cam2[4, -2], mask2[4, -2] = -1, True
    cases["present-minus-one"] = (cam2, mask2, 33)
    cases["N0"] = (np.zeros((0, 5), np.int32), np.zeros((0, 5), bool), 7)
    cases["none-present"] = (cam, np.zeros_like(mask), 33)
    return cases


@pytest.mark.parametrize("case", list(_index_cases()))
def test_observation_index(case):
    """Every present slot once, under its camera, in (n, o) order within
    its view; the first-of-pair flags; the largest view's count."""
    cam, mask, V = _index_cases()[case]
    idx = tba.observation_index(torch.as_tensor(cam), torch.as_tensor(mask),
                                V)
    N, O = cam.shape
    slot, start, first = (getattr(idx, k).numpy() for k in
                          ("slot", "start", "first"))
    assert idx.slot.dtype == torch.int32 and idx.start.dtype == torch.int32
    assert start.shape == (V + 1,) and start[0] == 0
    want, want_first = [], []
    for v in range(V):
        seg = [n * O + o for n in range(N) for o in range(O)
               if mask[n, o] and max(cam[n, o], 0) == v]
        want += seg
        want_first += [k == 0 or seg[k] // O != seg[k - 1] // O
                       for k in range(len(seg))]
        assert start[v + 1] - start[v] == len(seg)
    np.testing.assert_array_equal(slot, np.asarray(want, np.int32))
    np.testing.assert_array_equal(first, np.asarray(want_first, bool))
    assert np.array_equal(np.sort(slot), np.flatnonzero(mask.reshape(-1)))
    assert idx.max_count == (int(np.diff(start).max()) if V else 0)
    if case == "packed-V33":
        assert (~first).sum() == (N + 2) // 3       # the duplicates
    if case == "present-minus-one":
        assert 4 * O + O - 2 in slot[start[0]:start[1]]


def test_observation_index_rejects_a_camera_beyond_v():
    cam = np.array([[0, 1], [2, 5]], np.int32)
    with pytest.raises(ValueError, match=">= V"):
        tba.observation_index(torch.as_tensor(cam),
                              torch.ones(2, 2, dtype=torch.bool), 4)


F32 = np.float32


def _observe_np(K, R, t, X, xy):
    """csrc/ba_blocks.cu `observe` on numpy f32 arrays, in its operation
    order: K, R [M, 3, 3], t, X [M, 3], xy [M, 2] -> r [M, 2],
    jc [M, 2, 6], jx [M, 2, 3]."""
    p = [R[:, i, 0] * X[:, 0] + R[:, i, 1] * X[:, 1] + R[:, i, 2] * X[:, 2]
         + t[:, i] for i in range(3)]
    small = np.abs(p[2]) < F32(1e-9)
    z = np.where(small, F32(1e-9), p[2])
    pz = [p[0] / z, p[1] / z, p[2] / z]
    a = F32(1.0) / z
    r, jc, jx = [], [], []
    for i in range(2):
        k0, k1, k2 = K[:, i, 0], K[:, i, 1], K[:, i, 2]
        proj = k0 * pz[0] + k1 * pz[1] + k2 * pz[2]
        r.append(xy[:, i] - proj)
        d = [k0 * a, k1 * a, np.where(small, k2, k2 - proj) * a]
        jc.append(np.stack([p[1] * d[2] - p[2] * d[1],
                            p[2] * d[0] - p[0] * d[2],
                            p[0] * d[1] - p[1] * d[0], *d], -1))
        jx.append(np.stack([R[:, 0, j] * d[0] + R[:, 1, j] * d[1]
                            + R[:, 2, j] * d[2] for j in range(3)], -1))
    return np.stack(r, -1), np.stack(jc, 1), np.stack(jx, 1)


def _tree(x):
    """A warp's shuffle-down tree over the last axis (32 lanes): what
    lane 0 holds."""
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _in_order(x):
    """A sequential f32 sum over the first axis, from 0."""
    s = np.zeros(x.shape[1:], F32)
    for row in x:
        s = s + row
    return s


def _k8_model(arrays, obs, damping, index):
    """K8's reductions in numpy f32, step by step as the kernels order
    them.  Point phase: lane v of a point's warp (views v, v + 32, ...)
    walks the slots in order for its B rows and its share of Hxx and gx;
    the shares meet in a butterfly; each lane inverts and forms its A
    rows.  View phase: chunks of BA_VIEW_OBS index entries, 4 a thread
    of 256 in order, a shuffle tree a warp, the 8 warps in order; the
    finish sums each view's chunks in order, and the residual over every
    (view, chunk) partial by 1,024 strided threads, a tree a warp and the
    32 warps in order."""
    K, R, t, X = arrays
    cam, xy, mask = obs
    V, (N, O) = K.shape[0], cam.shape
    cl = np.maximum(cam, 0)
    h = np.zeros((N, 32, 6), F32)
    g = np.zeros((N, 32, 3), F32)
    B = np.zeros((N, 3, V, 6), F32)
    for p in range(-(-V // 32)):
        b = np.zeros((N, 32, 3, 6), F32)
        for o in range(O):
            lane = cl[:, o] - 32 * p
            rows = np.flatnonzero(mask[:, o] & (lane >= 0) & (lane < 32))
            if not len(rows):
                continue
            v, ln = cl[rows, o], lane[rows]
            r, jc, jx = _observe_np(K[v], R[v], t[v], X[rows], xy[rows, o])
            h[rows, ln] += np.stack(
                [jx[:, 0, i] * jx[:, 0, j] + jx[:, 1, i] * jx[:, 1, j]
                 for i in range(3) for j in range(i, 3)], -1)
            g[rows, ln] += jx[:, 0] * r[:, :1] + jx[:, 1] * r[:, 1:]
            b[rows, ln] += (jx[:, 0, :, None] * jc[:, 0, None, :]
                            + jx[:, 1, :, None] * jc[:, 1, None, :])
        views = np.arange(32 * p, min(32 * p + 32, V))
        B[:, :, views] = b[:, :len(views)].transpose(0, 2, 1, 3)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        h = h + h[:, lanes ^ off]
        g = g + g[:, lanes ^ off]
    h, gx = h[:, 0], g[:, 0]
    dmp = F32(damping)
    a, bb, cc = (h[:, 0] + dmp * h[:, 0]) + F32(1e-8), h[:, 1], h[:, 2]
    d, e, f = h[:, 1], (h[:, 3] + dmp * h[:, 3]) + F32(1e-8), h[:, 4]
    gg, hh, ii = h[:, 2], h[:, 4], (h[:, 5] + dmp * h[:, 5]) + F32(1e-8)
    det = (a * (e * ii - f * hh) - bb * (d * ii - f * gg)
           + cc * (d * hh - e * gg))
    det = np.where(np.abs(det) < F32(1e-20),
                   np.where(det < 0, F32(-1e-20), F32(1e-20)), det)
    inv = np.stack([
        np.stack([e * ii - f * hh, cc * hh - bb * ii, bb * f - cc * e], -1),
        np.stack([f * gg - d * ii, a * ii - cc * gg, cc * d - a * f], -1),
        np.stack([d * hh - e * gg, bb * gg - a * hh, a * e - bb * d], -1),
    ], -2) / det[:, None, None]
    A = (B[:, 0, :, :, None] * inv[:, None, None, 0, :]
         + B[:, 1, :, :, None] * inv[:, None, None, 1, :]
         + B[:, 2, :, :, None] * inv[:, None, None, 2, :])   # [N, V, 6, 3]
    A = A.transpose(1, 2, 0, 3)

    slot, start, first = (getattr(index, k).numpy() for k in
                          ("slot", "start", "first"))
    chunks = max(1, -(-index.max_count // tba.BA_VIEW_OBS))
    partial = np.zeros((V, chunks, tba.BA_SUMS), F32)
    upper = [(i, j) for i in range(6) for j in range(i, 6)]
    xy_flat = xy.reshape(-1, 2)
    for v in range(V):
        seg = slot[start[v]:start[v + 1]]
        n = seg // O
        one = lambda x: np.repeat(x[v:v + 1], len(seg), 0)
        r, jc, _ = _observe_np(one(K), one(R), one(t), X[n], xy_flat[seg])
        agx = np.stack([A[v, i, n, 0] * gx[n, 0] + A[v, i, n, 1] * gx[n, 1]
                        + A[v, i, n, 2] * gx[n, 2] for i in range(6)], -1)
        terms = np.concatenate([
            np.stack([jc[:, 0, i] * jc[:, 0, j] + jc[:, 1, i] * jc[:, 1, j]
                      for i, j in upper], -1),
            jc[:, 0] * r[:, :1] + jc[:, 1] * r[:, 1:],
            np.where(first[start[v]:start[v + 1], None], agx, F32(0)),
            (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1])[:, None]], -1)
        terms = np.concatenate(
            [terms, np.zeros((chunks * tba.BA_VIEW_OBS - len(seg),
                              tba.BA_SUMS), F32)])
        for c in range(chunks):
            per_thread = _in_order(terms[c * tba.BA_VIEW_OBS:(c + 1)
                                         * tba.BA_VIEW_OBS].reshape(4, 256, -1))
            warps = _tree(per_thread.reshape(8, 32, -1).transpose(0, 2, 1))
            partial[v, c] = _in_order(warps)
    tot = np.stack([_in_order(partial[v]) for v in range(V)])
    Hcc = np.zeros((V, 6, 6), F32)
    for q, (i, j) in enumerate(upper):
        Hcc[:, i, j] = Hcc[:, j, i] = tot[:, q]
    gc = tot[:, 21:27]
    rows = partial.reshape(V * chunks, -1)[:, 33]
    rows = np.concatenate([rows, np.zeros((-len(rows)) % 1024, F32)])
    per_thread = _in_order(rows.reshape(-1, 1024))
    resid = _in_order(_tree(per_thread.reshape(32, 32)))
    return tba.BABlocks(*(torch.as_tensor(x) for x in (
        inv, gx, B, A, Hcc, gc, gc - tot[:, 27:33], resid)),
        n_obs=torch.as_tensor(int(start[V])))


def _model_cases():
    from test_torch_cuda_kernels import random_ba_problem
    cases = {f"{lay}-V{V}": (V, 203, lay) for V in (1, 33, 65)
             for lay in ("dense", "packed")}
    cases["dense-V4-chunks"] = (4, 3001, "dense")
    return cases, random_ba_problem


@pytest.mark.parametrize("case", ["scene-packed", "scene-dense",
                                  *_model_cases()[0]])
def test_k8_reduction_model_matches_plain_and_jax(ba_problem, case):
    """The model of K8's reductions against `_ba_blocks_plain` and JAX's
    `ba_schur_local` (S too): within 1e-5 of each array's largest
    magnitude, the residual sum within 1e-5 relative, the observation
    count exact.  The random problems as the card's tests make them
    (V = 1 with damping 1: one view leaves depth unobservable), and one
    with three chunks of view sums a view."""
    if case.startswith("scene"):
        sfmd, arrays = ba_problem
        obs = _observations(sfmd, case.split("-")[1])
        damping = 1e-4
    else:
        cases, make = _model_cases()
        V, N, layout = cases[case]
        arrays, obs = make(V, N, layout)
        damping = 1.0 if V == 1 else 1e-4
    V = arrays[0].shape[0]
    targs = [torch.as_tensor(a) for a in obs]
    index = tba.observation_index(targs[0], targs[2], V)
    got = _k8_model(arrays, obs, damping, index)
    if case == "dense-V4-chunks":
        assert index.max_count > 2 * tba.BA_VIEW_OBS
    _, ts = _states(arrays)
    ref = tba._ba_blocks_plain(ts, *targs, damping=damping)
    for name in tba.BABlocks._fields:
        g, r = getattr(got, name), getattr(ref, name)
        assert g.shape == r.shape, name
        if name == "n_obs":
            assert int(g) == int(r) == obs[2].sum()
        elif name == "resid_sq":
            np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
        else:
            assert _rel(g, r) < 1e-5, name
    js, _ = _states(arrays)
    S_j, rhs_j, Hinv_j, gx_j, _, onehot, rsq_j, n_j = jax.jit(
        jba.ba_schur_local)(js, *(jnp.asarray(a) for a in obs),
                            damping=damping)
    S_j = np.asarray(S_j).transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
    for g, r in ((tba.schur_complement(got), S_j), (got.rhs, rhs_j),
                 (got.Hxx_inv, Hinv_j), (got.gx, gx_j)):
        assert _rel(g, r) < 1e-5
    np.testing.assert_allclose(float(got.resid_sq), float(rsq_j), rtol=1e-5)
    assert int(n_j) == int(got.n_obs)


def test_ba_run_builds_the_index_once(ba_problem, monkeypatch):
    """ba_run builds the observation index once for all its steps, and
    its steps equal steps that each build their own, bit for bit (on
    the CPU, where the plain version runs)."""
    sfmd, arrays = ba_problem
    _, ts = _states(arrays)
    obs = [torch.as_tensor(a) for a in _observations(sfmd, "packed")]
    built = []
    real = tba.observation_index
    monkeypatch.setattr(tba, "observation_index",
                        lambda *a: built.append(1) or real(*a))
    st, mses = tba.ba_run(ts, *obs, 3)
    assert len(built) == 1
    st2, mses2 = ts, []
    for _ in range(3):
        st2, mse = tba.ba_step_single(st2, *obs)
        mses2.append(mse)
    for name in ("R", "t", "X"):
        assert torch.equal(getattr(st, name), getattr(st2, name)), name
    assert torch.equal(mses, torch.stack(mses2))
