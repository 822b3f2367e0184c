"""The pipeline end to end: the port's `run_pipeline(device="cpu")`
against the JAX `run_pipeline` on the same scene, with stage 3 alone and
with the default stages (1, 2, 3), and the port's independence from jax.

Tolerance: the same number of output points, the same per-point view
sets in the same order, and coordinates within 1e-4 (scene units; the
cube spans 1.2).  No threshold flip occurred on these scenes, so none
is excused.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.pipeline import PipelineStats as JStats
from edgegraph3d_tpu.pipeline import run_pipeline as jax_run
from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=128)


@pytest.fixture(scope="module")
def cube():
    require_jax_native_lib()
    return synthetic.make_cube_scene(n_cams=8, n_refpoints_per_edge=8,
                                     width=320, height_px=240, focal=400.0,
                                     seed=7)


@pytest.mark.parametrize("steps,msv", [(64, 2), (4, 2), (16, None)])
def test_stage3_pipeline_matches_jax(cube, steps, msv):
    """steps=4 forces truncated chains and continuation rounds; msv=None
    starts from every viewing camera."""
    sfmd, imgs, curves = cube
    j = jax_run(sfmd, imgs, EdgeGraphConfig().replace(
        max_follow_steps=steps, **KW), max_starting_views=msv, stages=(3,))
    stats = tp.PipelineStats()
    t = tp.run_pipeline(sfmd, imgs, TConfig().replace(
        max_follow_steps=steps, **KW), max_starting_views=msv, stages=(3,),
        stats=stats, device="cpu")
    n0 = sfmd.n_points
    assert t.n_points == j.n_points > n0 + 20
    assert [c.tolist() for c in t.obs_cam[n0:]] == \
        [c.tolist() for c in j.obs_cam[n0:]]
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=1e-4)
    if steps == 4:
        assert stats.counters["continuation_rounds"] > 0
    cc = np.concatenate(curves)
    d = np.sqrt(((t.points[n0:, None] - cc[None]) ** 2).sum(-1)).min(1)
    assert np.median(d) < 0.03


def test_default_stages_match_jax(cube):
    """Stages 1, 2 and 3 with one shared claim manager.  The relaxed
    closeness ratio makes stage 2 produce match sets on this noise-free
    scene (see tests/test_polyline_stages.py), so both group sweeps run."""
    sfmd, imgs, _ = cube
    kw = dict(max_follow_steps=64, closeness_max_dist_ratio=1e6, **KW)
    js = JStats()
    j = jax_run(sfmd, imgs, EdgeGraphConfig().replace(**kw),
                max_starting_views=2, stats=js)
    ts = tp.PipelineStats()
    t = tp.run_pipeline(sfmd, imgs, TConfig().replace(**kw),
                        max_starting_views=2, stats=ts, device="cpu")
    n0 = sfmd.n_points
    assert t.n_points == j.n_points > n0 + 20
    assert [c.tolist() for c in t.obs_cam[n0:]] == \
        [c.tolist() for c in j.obs_cam[n0:]]
    np.testing.assert_allclose(t.points, j.points, rtol=0, atol=1e-4)
    for name in ("stage1_similarity_graph", "stage1_sweep",
                 "stage2_closeness_graph", "stage2_sweep",
                 "stage3_refpoints", "expand_all_views"):
        assert ts.counts[name] == js.counts[name], name
    assert ts.counts["stage1_sweep"] > 0 and ts.counts["stage2_sweep"] > 0
    for name in ("stage1_close", "stage1_graph", "stage1_communities"):
        assert name in ts.timings


def test_debug_images_write_the_jax_suite(cube, tmp_path):
    """run_pipeline(debug_images=True) with a working folder writes the
    JAX package's debug-image files (the same names), every family of
    test_drawing.py's suite among them, with claimed arcs drawn red.
    Without a working folder it runs and returns the same points."""
    from PIL import Image
    sfmd, imgs, _ = cube
    # closeness_max_dist_ratio=1e6: stage 2 makes sets (pmctr images) on
    # this noise-free scene
    kw = dict(closeness_max_dist_ratio=1e6, **KW)
    j = jax_run(sfmd, imgs, EdgeGraphConfig().replace(**kw),
                working_folder=str(tmp_path / "j"), max_starting_views=2,
                debug_images=True)
    stats = tp.PipelineStats()
    t = tp.run_pipeline(sfmd, imgs, TConfig().replace(**kw),
                        working_folder=str(tmp_path / "t"),
                        max_starting_views=2, stats=stats,
                        debug_images=True, device="cpu")
    assert t.n_points == j.n_points > sfmd.n_points
    png = lambda d: sorted(n for n in (tmp_path / d).iterdir()
                           if n.suffix == ".png")
    names = [n.name for n in png("t")]
    assert names == [n.name for n in png("j")]
    for prefix in ("plgs_imgs", "plgs_comp", "output_on_imgs",
                   "output_on_plgs", "pmsg", "pmctr", "epipolar",
                   "claimed_intervals", "chains", "detection",
                   "pmsg_comm", "pmsg_epi"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert sum(n.startswith("detection_") for n in names) == \
        3 * sfmd.n_cameras
    reds = 0
    for n in png("t"):
        if n.name.startswith("claimed_intervals"):
            img = np.asarray(Image.open(n))
            reds += int(((img[..., 0] > 200) & (img[..., 1] < 100)).sum())
    assert reds > 0, "no claimed arcs rendered"
    assert stats.timings["debug_images"] > 0
    plain = tp.run_pipeline(sfmd, imgs, TConfig().replace(**kw),
                            max_starting_views=2, debug_images=True,
                            device="cpu")
    np.testing.assert_array_equal(plain.points, t.points)


def test_cuda_request_without_gpu_raises(cube, monkeypatch):
    sfmd, imgs, _ = cube
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tp.run_pipeline(sfmd, imgs, TConfig().replace(**KW), stages=(3,))


@pytest.mark.parametrize("fn", ["gauss_newton_filter", "compute_inliers",
                                "filter_sfm_data", "communities_from_edges",
                                "context_from_arrays"])
def test_library_functions_default_to_the_card(cube, monkeypatch, fn):
    """The public library functions default to device="cuda": without a
    GPU the default raises, and the CPU runs only when asked for."""
    from edgegraph3d_tpu_torch.filtering import outliers
    from edgegraph3d_tpu_torch.matching import communities, refpoints
    sfmd, _, _ = cube
    edges = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    call = {
        "gauss_newton_filter": lambda **kw: outliers.gauss_newton_filter(
            sfmd, **kw),
        "compute_inliers": lambda **kw: outliers.compute_inliers(
            sfmd, sfmd.n_points, **kw),
        "filter_sfm_data": lambda **kw: outliers.filter_sfm_data(
            sfmd, sfmd.n_points, **kw),
        "communities_from_edges": lambda **kw:
            communities.communities_from_edges(edges, np.ones(3), 3, **kw),
        "context_from_arrays": lambda **kw: refpoints.context_from_arrays(
            np.zeros((1, 1, 2, 2)), np.zeros((1, 1)),
            np.zeros((1, 1, 1, 1, 6)), sfmd.P[:1], np.zeros((1, 1, 3, 3)),
            10.0, **kw),
    }[fn]
    assert call(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        call()


def test_working_folder_outputs(cube, tmp_path):
    sfmd, imgs, _ = cube
    cfg = TConfig().replace(max_follow_steps=16, **KW)
    out = tp.run_pipeline(sfmd, imgs, cfg, working_folder=str(tmp_path),
                          max_starting_views=2, stages=(3,), device="cpu")
    for name in ("plgs.npz", "before_filtering.json", "outgraph_3d.npz",
                 "stats.json"):
        assert (tmp_path / name).exists(), name
    man = json.load(open(tmp_path / "stats.json"))
    assert man["n_points_out"] == out.n_points
    assert man["config_hash"] == tp.config_hash(cfg)


def test_port_never_imports_jax(tmp_path):
    """Run the port's pipeline, default stages with the optional paths
    (joint BA, device claiming, the LMedS table), alone and on a 2-shard
    CPU mesh (parallel/), in a fresh interpreter where importing jax (or
    the JAX package) fails."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["edgegraph3d_tpu"] = None
        from edgegraph3d_tpu_torch.config import EdgeGraphConfig
        from edgegraph3d_tpu_torch.core import synthetic
        from edgegraph3d_tpu_torch.pipeline import run_pipeline
        import edgegraph3d_tpu_torch.quality, edgegraph3d_tpu_torch.kernels
        import edgegraph3d_tpu_torch.cli.edge_graph_3d
        import edgegraph3d_tpu_torch.cli.filter
        import edgegraph3d_tpu_torch.ops.ba
        import edgegraph3d_tpu_torch.matching.claiming_device
        from edgegraph3d_tpu_torch.parallel import distributed, mesh, sharded
        sfmd, imgs, curves = synthetic.make_cube_scene(
            n_cams=6, n_refpoints_per_edge=4, width=320, height_px=240,
            focal=400.0, seed=7)
        cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                        max_polyline_len=128,
                                        max_follow_steps=16, ba_steps=1,
                                        claiming_backend="device",
                                        fmat_source="lmeds")
        out = run_pipeline(sfmd, imgs, cfg, max_starting_views=2,
                           device="cpu")
        two = run_pipeline(sfmd, imgs, cfg, max_starting_views=2,
                           device="cpu",
                           mesh=mesh.make_mesh(devices=["cpu"] * 2))
        assert two.n_points == out.n_points
        assert not any(m == "jax" or m.startswith("jax.")
                       for m, v in sys.modules.items() if v is not None)
        print("POINTS", out.n_points - sfmd.n_points)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split("POINTS")[1]) > 0
