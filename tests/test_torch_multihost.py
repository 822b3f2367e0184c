"""The port's mesh across processes: 2 local processes joined by
torch.distributed over gloo, each driving 2 CPU shards, so the global
mesh has 4 shards across a real process boundary (the counterpart of
tests/test_multihost.py, which runs jax.distributed the same way).

Each worker runs the sharded per-point GN, 2 steps of the distributed
BA and run_pipeline(mesh=global_mesh()) on the same seeded scene.  Both
processes must return the same arrays bit for bit (the host state is
identical on every process, and every sharded result is gathered to
every process); they must equal the single-process port (GN and the
pipeline bit for bit; the BA within tests/test_ba.py's bounds, its sums
run in another order), and the pipeline's point count must equal the
JAX package's single-process run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import sys
import numpy as np
import torch

rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
sys.modules["jax"] = None          # the port never needs it
from edgegraph3d_tpu_torch.parallel import distributed as dist
dist.initialize(f"127.0.0.1:{port}", world, rank, local_device_count=2,
                backend="gloo")
mesh = dist.global_mesh(devices=["cpu", "cpu"])
assert (mesh.size, mesh.first) == (2 * world, 2 * rank), mesh

from multihost_problem import gn_ba_problem, pipeline_problem
from edgegraph3d_tpu_torch.ops import ba as tba
from edgegraph3d_tpu_torch.parallel import sharded
from edgegraph3d_tpu_torch.pipeline import run_pipeline

state, (cam, xy, mask), P_obs = gn_ba_problem()
X, mse, ok = sharded.sharded_gauss_newton(mesh, P_obs, xy, mask, state.X)
st, mses = sharded.distributed_ba(mesh, state, cam, xy, mask, n_steps=2)
sfmd, imgs, cfg = pipeline_problem()
out = run_pipeline(sfmd, imgs, cfg, mesh=mesh, device="cpu")
np.savez(out_path, gn_X=X.numpy(), gn_ok=ok.numpy(), ba_X=st.X.numpy(),
         ba_R=st.R.numpy(), ba_mses=mses.numpy(), points=out.points,
         n_points=out.n_points, size=mesh.size,
         obs=np.concatenate(out.obs_cam))
"""

PROBLEM = r"""
import numpy as np
import torch

from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import sfm, synthetic
from edgegraph3d_tpu_torch.ops import ba as tba


def gn_ba_problem():
    sfmd, _, _ = synthetic.make_scene(n_cams=4, n_refpoints_per_curve=8,
                                      width=320, height_px=240, focal=400.0,
                                      seed=0)
    packed = sfm.pack_observations(sfmd.obs_cam, sfmd.obs_xy, max_obs=4,
                                   dtype=np.float32)
    rng = np.random.default_rng(0)
    X0 = (sfmd.points + rng.normal(0, 0.01, sfmd.points.shape)).astype(
        np.float32)
    cam = packed.cam_idx.astype(np.int32)
    P_obs = sfmd.P.astype(np.float32)[np.clip(cam, 0, None)]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    state = tba.BAState(K=f32(sfmd.K), R=f32(sfmd.R), t=f32(sfmd.t),
                        X=f32(X0))
    obs = (torch.as_tensor(cam), f32(packed.xy),
           torch.as_tensor(packed.mask))
    return state, obs, torch.as_tensor(P_obs)


def pipeline_problem():
    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=64, max_follow_steps=16)
    sfmd, imgs, _ = synthetic.make_scene(
        n_cams=4, n_refpoints_per_curve=8, width=320, height_px=240,
        focal=400.0, seed=0)
    return sfmd, imgs, cfg
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_mesh(tmp_path):
    (tmp_path / "worker.py").write_text(WORKER)
    (tmp_path / "multihost_problem.py").write_text(PROBLEM)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, str(tmp_path), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    port = _free_port()
    procs, outs = [], []
    for rank in range(2):
        out = tmp_path / f"out{rank}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp_path / "worker.py"), str(rank), "2",
             str(port), str(out)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    logs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("gloo workers timed out")
        logs.append((p.returncode, err.decode()[-3000:]))
    assert [rc for rc, _ in logs] == [0, 0], logs
    r0, r1 = (dict(np.load(o)) for o in outs)
    assert int(r0["size"]) == int(r1["size"]) == 4
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    # the single-process port, unsharded
    sys.path.insert(0, str(tmp_path))
    try:
        from multihost_problem import gn_ba_problem, pipeline_problem
    finally:
        sys.path.remove(str(tmp_path))
    from edgegraph3d_tpu_torch.ops import ba as tba
    from edgegraph3d_tpu_torch.ops.triangulation import gauss_newton_batched
    from edgegraph3d_tpu_torch.pipeline import run_pipeline
    state, (cam, xy, mask), P_obs = gn_ba_problem()
    X, _, ok = gauss_newton_batched(P_obs, xy, mask, state.X)
    np.testing.assert_array_equal(r0["gn_X"], X.numpy())
    np.testing.assert_array_equal(r0["gn_ok"], ok.numpy())
    assert ok.sum() > 0.9 * len(ok)
    st, mses = tba.ba_run(state, cam, xy, mask, 2)
    np.testing.assert_allclose(r0["ba_R"], st.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(r0["ba_X"], st.X.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["ba_mses"], mses.numpy(), rtol=0,
                               atol=1e-3)
    assert r0["ba_mses"][-1] < 1e-3
    sfmd, imgs, cfg = pipeline_problem()
    single = run_pipeline(sfmd, imgs, cfg, device="cpu")
    np.testing.assert_array_equal(r0["points"], single.points)
    np.testing.assert_array_equal(r0["obs"], np.concatenate(single.obs_cam))

    # the JAX package's single-process run of the same scene
    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.core import synthetic
    from edgegraph3d_tpu.pipeline import run_pipeline as jax_run
    from test_torch_native import require_jax_native_lib
    require_jax_native_lib()
    jsfmd, jimgs, _ = synthetic.make_scene(
        n_cams=4, n_refpoints_per_curve=8, width=320, height_px=240,
        focal=400.0, seed=0)
    j = jax_run(jsfmd, jimgs, EdgeGraphConfig().replace(
        max_polylines_per_view=256, max_polyline_len=64,
        max_follow_steps=16))
    assert int(r0["n_points"]) == j.n_points > jsfmd.n_points
    np.testing.assert_allclose(r0["points"], j.points, rtol=0, atol=1e-4)
