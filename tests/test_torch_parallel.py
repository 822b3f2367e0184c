"""The port's mesh (edgegraph3d_tpu_torch/parallel) in one process: its
helpers and collectives, the sharded per-point GN, the distributed BA
and the sharded device claiming, each against the JAX package's mesh
version on its 8 virtual CPU devices (tests/conftest.py) and against the
port's single-device version.

Tolerances:
  * mesh helpers, collectives and claiming: exact (integers, or sums of
    small integers in f32);
  * sharded GN: points within 1e-5 and the same valid set as JAX's, and
    bit-equal to the port's unsharded GN (per-point math, no collective);
  * distributed BA: rotations within 1e-5, points within 1e-4, the MSE
    within 1e-3 (tests/test_ba.py's bounds), translations, which those
    tests leave out, within 1e-5 (1 + max |t|) (they reach ~4.5 scene
    units here): its sums run in shard order, so it differs from the
    single-device BA by rounding only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.core import sfm as j_sfm
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import claiming_device as j_claim
from edgegraph3d_tpu.ops import ba as jba
from edgegraph3d_tpu.parallel import mesh as j_mesh
from edgegraph3d_tpu.parallel import sharded as j_sharded
from edgegraph3d_tpu_torch.matching import claiming_device as t_claim
from edgegraph3d_tpu_torch.matching import matches as t_matches
from edgegraph3d_tpu_torch.ops import ba as tba
from edgegraph3d_tpu_torch.ops.triangulation import gauss_newton_batched
from edgegraph3d_tpu_torch.parallel import distributed as t_dist
from edgegraph3d_tpu_torch.parallel import mesh as t_mesh
from edgegraph3d_tpu_torch.parallel import sharded as t_sharded
from test_claiming import _random_claim_problem


def cpu_mesh(n):
    return t_mesh.make_mesh(devices=["cpu"] * n)


# ----------------------------------------------------------------------
# mesh helpers and collectives
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,mult", [(10, 8), (16, 8), (0, 3), (7, 1)])
def test_pad_to_multiple_matches_jax(n, mult):
    a = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    np.testing.assert_array_equal(t_mesh.pad_to_multiple(a, mult, fill=-1),
                                  j_mesh.pad_to_multiple(a, mult, fill=-1))


@pytest.mark.parametrize("n,shards", [(16, 8), (10, 8), (10, 3), (0, 4),
                                      (3, 5)])
def test_shard_bounds_cover_the_axis_in_order(n, shards):
    b = t_mesh.shard_bounds(n, shards)
    assert len(b) == shards and b[0][0] == 0 and b[-1][1] == n
    assert all(lo <= hi for lo, hi in b)
    assert all(b[i][1] == b[i + 1][0] for i in range(shards - 1))
    sizes = [hi - lo for lo, hi in b]
    assert max(sizes) == -(-n // shards)
    if n % shards == 0:
        assert len(set(sizes)) == 1
    m = cpu_mesh(shards)
    assert [(g, lo, hi) for g, _, lo, hi in m.local_bounds(n)] == \
        [(g, lo, hi) for g, (lo, hi) in enumerate(b)]


def test_mesh_shape():
    m = cpu_mesh(4)
    assert (m.size, m.local, m.first, m.world) == (4, 4, 0, 1)
    assert m.device == torch.device("cpu") and m.group is None
    assert [g for g, _ in m.local_shards()] == [0, 1, 2, 3]


def test_collectives_in_one_process():
    m = cpu_mesh(3)
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.integers(-50, 50, (4, 5)).astype(np.float32))
             for _ in range(3)]
    np.testing.assert_array_equal(t_mesh.psum(m, parts).numpy(),
                                  sum(p.numpy() for p in parts))
    np.testing.assert_array_equal(
        t_mesh.pmin(m, parts).numpy(),
        np.minimum.reduce([p.numpy() for p in parts]))
    np.testing.assert_array_equal(
        t_mesh.pmax(m, parts).numpy(),
        np.maximum.reduce([p.numpy() for p in parts]))
    blocks = [torch.arange(3), torch.zeros(0, dtype=torch.int64),
              torch.arange(2) + 10]
    assert t_mesh.all_gather(m, blocks).tolist() == [0, 1, 2, 10, 11]
    got = t_mesh.gather_fields(m, [dict(a=b, b=b * 2) for b in blocks])
    assert got["b"].tolist() == [0, 2, 4, 20, 22]
    with pytest.raises(ValueError, match="3 local shards"):
        t_mesh.psum(m, parts[:2])


def test_shard_and_replicate_helpers():
    m = cpu_mesh(3)
    a = np.arange(14).reshape(7, 2)
    blocks = t_dist.shard_global(m, a)
    assert [len(b) for b in blocks] == [3, 3, 1]
    np.testing.assert_array_equal(t_dist.gather_to_host(m, blocks), a)
    reps = t_dist.replicate_global(m, a)
    assert len(reps) == 3 and reps[0] is reps[2]


def test_make_mesh_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_mesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_mesh.make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="nccl"):
        t_dist.initialize("127.0.0.1:1", 1, 0)
    assert cpu_mesh(2).size == 2


def test_make_mesh_refuses_more_shards_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="3 shards asked for, 2 CUDA"):
        t_mesh.make_mesh(3)
    with pytest.raises(ValueError, match="n_devices=2 but 3 devices"):
        t_mesh.make_mesh(2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="unsupported"):
        t_mesh.make_mesh(devices=["meta"])


# ----------------------------------------------------------------------
# per-point GN and the distributed BA
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_ba.py's problem: packed observations (O = 8, -1 for
    none), points and poses perturbed, padded to 8 shards."""
    sfmd, _, _ = synthetic.make_scene(n_cams=8, n_refpoints_per_curve=16,
                                      width=320, height_px=240,
                                      focal=400.0, seed=5)
    packed = j_sfm.pack_observations(sfmd.obs_cam, sfmd.obs_xy, max_obs=8,
                                     dtype=np.float32)
    rng = np.random.default_rng(0)
    X0 = sfmd.points + rng.normal(0, 0.01, sfmd.points.shape)
    w = rng.normal(0, 0.002, (sfmd.n_cameras, 3))
    R0 = np.asarray(jba.exp_so3(jnp.asarray(w))) @ sfmd.R
    t0 = sfmd.t + rng.normal(0, 0.005, sfmd.t.shape)
    pad = lambda a, fill=0: j_mesh.pad_to_multiple(np.asarray(a), 8,
                                                   fill=fill)
    obs = (pad(packed.cam_idx, -1).astype(np.int32), pad(packed.xy),
           pad(packed.mask))
    cams = [np.asarray(a, np.float32) for a in (sfmd.K, R0, t0)]
    return sfmd, cams, pad(np.asarray(X0, np.float32)), obs, packed.n_points


def _states(cams, X):
    arrays = [*cams, X]
    return (jba.BAState(*(jnp.asarray(a) for a in arrays)),
            tba.BAState(*(torch.as_tensor(a) for a in arrays)))


def test_sharded_gauss_newton_matches_jax_and_unsharded(ba_problem):
    sfmd, _, X, (cam, xy, mask), N = ba_problem
    P_obs = sfmd.P.astype(np.float32)[np.clip(cam, 0, None)]
    Xj, msej, okj = j_sharded.sharded_gauss_newton(
        j_mesh.make_mesh(8), *(jnp.asarray(a) for a in (P_obs, xy, mask, X)))
    args = [torch.as_tensor(a) for a in (P_obs, xy, mask, X)]
    Xt, mset, okt = t_sharded.sharded_gauss_newton(cpu_mesh(8), *args)
    Xs, _, oks = gauss_newton_batched(*args)
    assert okt.numpy()[:N].sum() > 0.9 * N
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Xt.numpy()[:N], np.asarray(Xj)[:N],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(Xt.numpy(), Xs.numpy())
    np.testing.assert_array_equal(okt.numpy(), oks.numpy())
    assert mset.shape == (len(X),)


def _ba_args(obs):
    return [torch.as_tensor(a) for a in obs], [jnp.asarray(a) for a in obs]


@pytest.mark.parametrize("shards", [8, 3])
def test_distributed_ba_step_matches_jax_and_single(ba_problem, shards):
    sfmd, cams, X, obs, N = ba_problem
    js, ts = _states(cams, X)
    targs, jargs = _ba_args(obs)
    st_j, mse_j = j_sharded.distributed_ba_step(j_mesh.make_mesh(8), js,
                                                *jargs, damping=1e-4)
    st_d, mse_d = t_sharded.distributed_ba_step(cpu_mesh(shards), ts, *targs,
                                                damping=1e-4)
    st_s, mse_s = tba.ba_step_single(ts, *targs, damping=1e-4)
    for ref in (st_j, st_s):
        np.testing.assert_allclose(st_d.R.numpy(), np.asarray(ref.R),
                                   atol=1e-5)
        t_ref = np.asarray(ref.t)
        np.testing.assert_allclose(st_d.t.numpy(), t_ref, rtol=0,
                                   atol=1e-5 * (1 + np.abs(t_ref).max()))
        np.testing.assert_allclose(st_d.X.numpy()[:N],
                                   np.asarray(ref.X)[:N], atol=1e-4)
    assert abs(mse_d.item() - float(mse_j)) < 1e-3
    assert abs(mse_d.item() - float(tba.ba_mse(ts, *targs))) < 1e-3
    assert st_d.X.shape == ts.X.shape


def test_distributed_ba_step_keeps_f64_with_empty_shards(ba_problem,
                                                        monkeypatch):
    """An f64 state over more shards than points: every buffer summed
    across the shards, the empty shards' zeros included, is f64, and the
    step equals the single-device one to rounding."""
    sfmd, _, _, _, _ = ba_problem
    n = 3
    packed = j_sfm.pack_observations(sfmd.obs_cam[:n], sfmd.obs_xy[:n],
                                     max_obs=8, dtype=np.float64)
    X = sfmd.points[:n] + np.random.default_rng(0).normal(0, 0.01, (n, 3))
    st = tba.BAState(*(torch.as_tensor(np.asarray(a, np.float64))
                       for a in (sfmd.K, sfmd.R, sfmd.t, X)))
    obs = [torch.as_tensor(a) for a in (packed.cam_idx.astype(np.int32),
                                        packed.xy, packed.mask)]
    psum = t_sharded.psum
    summed = []

    def same_dtype_psum(mesh, parts):
        summed.append({p.dtype for p in parts})
        return psum(mesh, parts)

    monkeypatch.setattr(t_sharded, "psum", same_dtype_psum)
    st_d, mse_d = t_sharded.distributed_ba_step(cpu_mesh(8), st, *obs,
                                                damping=1e-4)
    st_s, mse_s = tba.ba_step_single(st, *obs, damping=1e-4)
    assert summed and all(len(d) == 1 for d in summed), summed
    assert {torch.float64, torch.int64} >= set().union(*summed)
    for got, ref in ((st_d.R, st_s.R), (st_d.t, st_s.t), (st_d.X, st_s.X)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12)
    assert abs(mse_d.item() - mse_s.item()) < 1e-12


def test_distributed_ba_mse_falls_100x(ba_problem):
    sfmd, cams, X, obs, N = ba_problem
    js, ts = _states(cams, X)
    targs, jargs = _ba_args(obs)
    st, mses = t_sharded.distributed_ba(cpu_mesh(8), ts, *targs, n_steps=6)
    st_j, mses_j = j_sharded.distributed_ba(j_mesh.make_mesh(8), js, *jargs,
                                            n_steps=6)
    mses = mses.numpy()
    assert mses.shape == (6,) and mses[0] > 0.1
    assert mses[-1] < mses[0] * 1e-2
    np.testing.assert_allclose(mses, np.asarray(mses_j), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(st.X.numpy()[:N], np.asarray(st_j.X)[:N],
                               atol=1e-4)


def test_distributed_ba_builds_each_index_once(ba_problem, monkeypatch):
    sfmd, cams, X, obs, N = ba_problem
    _, ts = _states(cams, X)
    targs, _ = _ba_args(obs)
    calls = []
    orig = tba.observation_index
    monkeypatch.setattr(tba, "observation_index",
                        lambda *a: calls.append(1) or orig(*a))
    t_sharded.distributed_ba(cpu_mesh(4), ts, *targs, n_steps=3)
    assert len(calls) == 4


def test_run_shards_steps_every_shard_to_each_read_back():
    """sharded._run_shards steps every shard's step generator to its next
    yield (its work queued up to a read back) before any goes past it;
    plain functions run as they are; results come in the jobs' order."""
    events = []

    def steps(g):
        events.append(("queue", g))
        yield
        events.append(("read", g))
        yield
        events.append(("finish", g))
        return 10 * g

    out = t_sharded._run_shards([(0, steps, (0,)), (1, lambda: 7, ()),
                                 (2, steps, (2,))])
    assert out == [0, 7, 20]
    assert events == [("queue", 0), ("queue", 2), ("read", 0), ("read", 2),
                      ("finish", 0), ("finish", 2)]


# ----------------------------------------------------------------------
# sharded device claiming
# ----------------------------------------------------------------------

def _port_manager(jax_manager):
    m = t_matches.MatchesManager(jax_manager.lengths, buckets=jax_manager.B)
    m.raster = jax_manager.raster.copy()
    return m


@pytest.mark.parametrize("trial,shards", [(0, 8), (1, 8), (2, 3), (3, 7)])
def test_sharded_claiming_matches_host_and_jax(trial, shards):
    """_random_claim_problem's collision-rich chunks (S = 120, padded to
    the shard count with success=False rows): the port's sharded accept
    set and raster bit-equal to the host pass and to JAX's sharded
    claiming on its 8-device mesh, with and without the start check."""
    rng = np.random.default_rng(200 + trial)
    mm_host, mm_jdev, args = _random_claim_problem(rng)
    mm_port = _port_manager(mm_jdev)
    mm_single = _port_manager(mm_jdev)
    jm = j_mesh.make_mesh(8)
    for skip in (False, True):
        a_host = mm_host.resolve_and_claim(*args, skip_start_check=skip)
        a_jdev = j_claim.apply_device_claiming(mm_jdev, *args,
                                               skip_start_check=skip,
                                               mesh=jm)
        a_port = t_claim.apply_device_claiming(mm_port, *args,
                                               skip_start_check=skip,
                                               device="cpu",
                                               mesh=cpu_mesh(shards))
        a_single = t_claim.apply_device_claiming(mm_single, *args,
                                                 skip_start_check=skip,
                                                 device="cpu")
        assert (~a_port & args[0]).any() != skip
        for ref in (a_host, a_jdev, a_single):
            np.testing.assert_array_equal(a_port, ref)
        for ref in (mm_host, mm_jdev, mm_single):
            np.testing.assert_array_equal(mm_port.raster, ref.raster)
        assert mm_port.counters["seeds_skipped_claimed"] == \
            mm_host.counters["seeds_skipped_claimed"]
        for k in ("device_claiming_rounds", "device_claiming_rounds_max"):
            assert mm_port.counters[k] == mm_single.counters[k]
    assert "device_claiming_fallback" not in mm_port.counters


def test_sharded_fixpoint_cut_falls_back_to_host(monkeypatch):
    """A fixpoint cut by max_rounds on the mesh falls back to the exact
    host pass, counted, as on one device."""
    rng = np.random.default_rng(7)
    mm_host, mm_jdev, args = _random_claim_problem(rng)
    mm_port = _port_manager(mm_jdev)
    monkeypatch.setattr(t_claim, "MAX_ROUNDS", 1)
    a_port = t_claim.apply_device_claiming(mm_port, *args, device="cpu",
                                           mesh=cpu_mesh(4))
    a_host = mm_host.resolve_and_claim(*args)
    np.testing.assert_array_equal(a_port, a_host)
    np.testing.assert_array_equal(mm_port.raster, mm_host.raster)
    assert mm_port.counters["device_claiming_fallback"] == 1
