"""The port's reconstruction on a mesh of CPU shards against the JAX
package's on its 8 virtual CPU devices (tests/conftest.py), and against
the port's single-device run, on tests/test_sharded_pipeline.py's cube.

A mesh shards the work-item axis of every sweep (refpoints, seeds,
chains, points) and nothing crosses shards inside a sweep, so the
sharded run must equal the single-device one: the same points in the
same order, the same observation masks, seed refpoints, seed ids and
chain orders, coordinates within 1e-5 (they come out bit-equal here),
whatever the shard count and the refpoint chunk.  Against JAX's mesh
run: the same counts, masks and view lists, 3D coordinates within 1e-5
and image coordinates within 1e-3 px (the port's bound against JAX
elsewhere: the expansion's GN rounds otherwise than XLA's).  With joint
BA (its sums run in shard order) the points are held within 1e-4 and
the rotations within 1e-5, tests/test_ba.py's bounds.
"""

import numpy as np
import pytest

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import refpoints as j_rp
from edgegraph3d_tpu.parallel import mesh as j_mesh
from edgegraph3d_tpu.pipeline import run_pipeline as jax_run
from edgegraph3d_tpu.plgs.extraction import extract_plgs as j_extract
from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.matching import refpoints as t_rp
from edgegraph3d_tpu_torch.parallel import mesh as t_mesh
from edgegraph3d_tpu_torch.parallel import sharded as t_sharded
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs as t_extract
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=32)
FIELDS = ("obs_mask", "seed_refpoint", "seed_id", "chain_order")


def cpu_mesh(n):
    return t_mesh.make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def scene():
    require_jax_native_lib()
    return synthetic.make_cube_scene(n_cams=6, n_refpoints_per_edge=6,
                                     width=320, height_px=240, focal=400.0,
                                     seed=11)


@pytest.fixture(scope="module")
def stack(scene):
    return t_extract(scene[1], TConfig().replace(**KW))


@pytest.fixture(scope="module")
def single(scene, stack):
    """The port's single-device stage 3."""
    ctx = t_rp.build_context(scene[0], stack, TConfig().replace(**KW),
                             device="cpu")
    return t_rp.reconstruct_from_refpoints(scene[0], ctx)


def _assert_same_points(a, b, exact=True):
    assert len(a.X) == len(b.X) > 100
    np.testing.assert_allclose(a.X, b.X, rtol=0, atol=1e-5)
    for f in FIELDS if exact else FIELDS[:2]:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.obs_xy[a.obs_mask], b.obs_xy[b.obs_mask],
                               rtol=0, atol=1e-4 if exact else 1e-3)


def test_sharded_stage3_matches_jax_mesh_and_single(scene, stack, single):
    sfmd, imgs, _ = scene
    cfg = EdgeGraphConfig().replace(**KW)
    jctx = j_rp.build_context(sfmd, j_extract(imgs, cfg), cfg,
                              mesh=j_mesh.make_mesh(8))
    jpts = j_rp.reconstruct_from_refpoints(sfmd, jctx)
    ctx = t_rp.build_context(sfmd, stack, TConfig().replace(**KW),
                             device="cpu", mesh=cpu_mesh(8))
    assert ctx.n_shards == 8 and ctx.mesh.size == 8
    t_sharded.reset_shard_launches()
    pts = t_rp.reconstruct_from_refpoints(sfmd, ctx)
    _assert_same_points(pts, single)
    _assert_same_points(pts, jpts, exact=False)
    # every shard ran its own seeding, following and expansion (on the
    # CPU the wrappers take their plain versions: no launch is counted)
    assert sorted(t_sharded.SHARD_LAUNCHES) == list(range(8))


@pytest.mark.parametrize("shards,chunk,claiming", [
    (3, None, "host"), (5, 7, "host"), (4, 16, "device")])
def test_uneven_mesh_and_chunks_match_single(scene, stack, shards, chunk,
                                             claiming):
    """Shard counts that divide neither the refpoints nor the seeds, and
    refpoint chunks cut at 7 and 16: the mesh run takes the single-device
    run's chunks, so its points come out in the same order."""
    sfmd = scene[0]
    cfg = TConfig().replace(claiming_backend=claiming, **KW)
    ref = t_rp.reconstruct_from_refpoints(
        sfmd, t_rp.build_context(sfmd, stack, cfg, device="cpu"),
        refpoint_chunk=chunk)
    ctx = t_rp.build_context(sfmd, stack, cfg, device="cpu",
                             mesh=cpu_mesh(shards))
    pts = t_rp.reconstruct_from_refpoints(sfmd, ctx, refpoint_chunk=chunk)
    _assert_same_points(pts, ref)
    np.testing.assert_array_equal(pts.X, ref.X)


def test_context_replicas_are_shared_per_device(stack, scene):
    ctx = t_rp.build_context(scene[0], stack, TConfig().replace(**KW),
                             device="cpu", mesh=cpu_mesh(3))
    assert ctx.on("cpu") is ctx.on("cpu") and ctx.on("cpu").mesh is None
    assert ctx.on("cpu").grids is ctx.grids
    assert list(ctx.replicas) == [ctx.device]


def test_seeding_chunk_on_mesh_matches_single(scene, stack):
    """compute_seeds_chunk on a 3-shard mesh (chunks of 7 refpoints: each
    padded to 9 rows, shards of 3): the single-device chunk's seeds, in
    the same order, with the same refpoint rows."""
    import torch
    sfmd = scene[0]
    cfg = TConfig().replace(**KW)
    one = t_rp.build_context(sfmd, stack, cfg, device="cpu")
    ctx = t_rp.build_context(sfmd, stack, cfg, device="cpu",
                             mesh=cpu_mesh(3))
    obs_xy, obs_mask = t_rp.dense_observations(sfmd)
    start = t_rp._start_mask(obs_mask, 2)
    total = 0
    for lo in range(0, 35, 7):
        chunk = [torch.as_tensor(a[lo:lo + 7])
                 for a in (obs_xy, obs_mask, start)]
        want = t_rp.compute_seeds_chunk(one, *chunk)
        got = t_rp.compute_seeds_chunk(ctx, *chunk)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        total += len(want["cams"])
    assert total > 10


def test_sharded_seeding_queues_every_shard_before_reading(scene, stack,
                                                          monkeypatch):
    """On a mesh, every shard's K2 is queued before any shard reads its
    candidate count back and goes on to K3 (sharded._run_shards steps
    refpoints._seed_from_starts_steps), so distinct cards seed at the
    same time; the seeds equal the single-device chunk's."""
    import torch
    sfmd = scene[0]
    cfg = TConfig().replace(**KW)
    obs_xy, obs_mask = t_rp.dense_observations(sfmd)
    chunk = [torch.as_tensor(a[:30]) for a in (obs_xy, obs_mask, obs_mask)]
    want = t_rp.compute_seeds_chunk(
        t_rp.build_context(sfmd, stack, cfg, device="cpu"), *chunk)
    log = []
    for name in ("epipolar_topm_query", "triangulate_gn"):
        fn = getattr(t_rp, name)
        monkeypatch.setattr(t_rp, name, lambda *a, _f=fn, _n=name, **k:
                            log.append(_n) or _f(*a, **k))
    got = t_rp.compute_seeds_chunk(t_rp.build_context(
        sfmd, stack, cfg, device="cpu", mesh=cpu_mesh(3)), *chunk)
    assert log.count("epipolar_topm_query") == 3
    assert log.count("triangulate_gn") >= 2
    assert log == sorted(log)        # every K2 before the first K3
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert len(want["cams"]) > 5


@pytest.mark.parametrize("extra", [
    dict(), dict(closeness_max_dist_ratio=1e6), dict(ba_steps=2)],
    ids=["default", "stage2-sets", "ba-steps-2"])
def test_run_pipeline_mesh_matches_jax_and_single(scene, extra):
    """run_pipeline(mesh=) with the default stages against JAX's
    run_pipeline(mesh=make_mesh(8)) and the port's single-device run:
    the same points and view lists, coordinates within 1e-5; with
    closeness_max_dist_ratio=1e6 stage 2 makes match sets, and with
    ba_steps=2 joint BA runs sharded (distributed_ba: points within
    1e-4)."""
    sfmd, imgs, _ = scene
    j = jax_run(sfmd, imgs, EdgeGraphConfig().replace(**KW, **extra),
                max_starting_views=2, mesh=j_mesh.make_mesh(8))
    stats = tp.PipelineStats()
    t = tp.run_pipeline(sfmd, imgs, TConfig().replace(**KW, **extra),
                        max_starting_views=2, mesh=cpu_mesh(8),
                        device="cpu", stats=stats)
    one = tp.run_pipeline(sfmd, imgs, TConfig().replace(**KW, **extra),
                          max_starting_views=2, device="cpu")
    n0 = sfmd.n_points
    for ref in (j, one):
        assert t.n_points == ref.n_points > n0 + 20
        assert [c.tolist() for c in t.obs_cam[n0:]] == \
            [c.tolist() for c in ref.obs_cam[n0:]]
        np.testing.assert_allclose(t.points, ref.points, rtol=0,
                                   atol=1e-4 if "ba_steps" in extra else 1e-5)
    if "ba_steps" in extra:
        np.testing.assert_allclose(t.R, j.R, atol=1e-5)
        assert stats.counts["joint_ba"] == 2
    else:
        np.testing.assert_array_equal(t.points, one.points)
    if "closeness_max_dist_ratio" in extra:
        assert stats.counts["stage2_sweep"] > 0

