"""The port's command lines against the JAX package's, on files written
to a temporary directory: the same output JSON (same points, same
observing views, 3D coordinates within 1e-4 scene units and 2D
observations within 1e-3 px; each side rounds the GN and the walks in
its own order)."""

import json

import numpy as np
import pytest
from PIL import Image

from edgegraph3d_tpu.cli import edge_graph_3d as j_cli
from edgegraph3d_tpu.cli import filter as j_filter
from edgegraph3d_tpu.core import sfm as sfm_io
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu_torch.cli import edge_graph_3d as t_cli
from edgegraph3d_tpu_torch.cli import filter as t_filter
from test_torch_native import require_jax_native_lib


def _same_json(a_path, b_path):
    a = json.loads(open(a_path).read())
    b = json.loads(open(b_path).read())
    assert a.keys() == b.keys()
    for k in a:
        if k != "structure":
            assert a[k] == b[k], k
    sa, sb = a["structure"], b["structure"]
    assert len(sa) == len(sb) > 0
    for pa, pb in zip(sa, sb):
        assert pa["key"] == pb["key"]
        oa, ob = pa["value"]["observations"], pb["value"]["observations"]
        assert [o["key"] for o in oa] == [o["key"] for o in ob]
        np.testing.assert_allclose([o["value"]["x"] for o in oa],
                                   [o["value"]["x"] for o in ob],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(pa["value"]["X"], pb["value"]["X"],
                                   rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    require_jax_native_lib()
    root = tmp_path_factory.mktemp("cube")
    sfmd, imgs, _ = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    (root / "edges").mkdir()
    (root / "imgs").mkdir()
    for v in range(imgs.shape[0]):
        Image.fromarray(imgs[v]).save(
            root / "edges" / f"synthetic_{v:04d}.png")
    sfm_io.write_sfm_data(sfmd, str(root / "input.json"))
    return root, sfmd


def test_edge_graph_3d_cli_matches_jax(scene_files):
    """Default stages (1, 2, 3) through both command lines."""
    root, sfmd = scene_files
    args = lambda tag: [str(root / "imgs"), str(root / "edges"),
                        str(root / f"work_{tag}"), str(root / "input.json"),
                        str(root / f"out_{tag}.json"),
                        "--max-starting-views", "2"]
    assert j_cli.main(args("jax")) == 0
    assert t_cli.main(args("torch") + ["--device", "cpu"]) == 0
    _same_json(root / "out_torch.json", root / "out_jax.json")
    stats = json.loads((root / "work_torch" / "stats.json").read_text())
    assert stats["counts"]["stage1_sweep"] > 0
    out = sfm_io.read_sfm_data(str(root / "out_torch.json"))
    assert out.n_points > sfmd.n_points


@pytest.mark.parametrize("extra", [["-i"]])
def test_edge_graph_3d_cli_unported_options_raise(scene_files, extra):
    root, _ = scene_files
    with pytest.raises(NotImplementedError, match="item 9"):
        t_cli.main(extra + [str(root / "imgs"), str(root / "edges"),
                            str(root / "work_x"), str(root / "input.json"),
                            str(root / "out_x.json"), "--device", "cpu"])


@pytest.mark.parametrize("flags", [[], ["-e", "1.0", "-f", "4"]])
def test_filter_cli_matches_jax(tmp_path, flags):
    """A scene with appended edge-points (true points with 0.5 px noise,
    gross outliers, and too few views) filtered by both command lines."""
    rng = np.random.default_rng(0)
    sfmd, _, curves = synthetic.make_scene(
        n_cams=6, n_refpoints_per_curve=12, width=320, height_px=240,
        focal=400.0, seed=3)
    X = np.concatenate(curves)[::7]
    obs_cam, obs_xy = [], []
    for i, x in enumerate(X):
        cams = np.sort(rng.choice(sfmd.n_cameras,
                                  3 + i % (sfmd.n_cameras - 2),
                                  replace=False)).astype(np.int32)
        xh = np.append(x, 1.0)
        pr = np.einsum("vij,j->vi", sfmd.P[cams], xh)
        xy = pr[:, :2] / pr[:, 2:3] + rng.normal(0, 0.5, (len(cams), 2))
        if i % 5 == 0:
            xy[0] += 15.0                               # gross outlier
        obs_cam.append(cams)
        obs_xy.append(xy)
    aug = sfm_io.add_edge_points(sfmd, X + rng.normal(0, 0.002, X.shape),
                                 obs_cam, obs_xy)
    src = tmp_path / "in.json"
    sfm_io.write_sfm_data(aug, str(src))
    head = ["-s", str(sfmd.n_points)] + flags
    assert j_filter.main(head + [str(src), str(tmp_path / "j.json")]) == 0
    assert t_filter.main(head + [str(src), str(tmp_path / "t.json"),
                                 "--device", "cpu"]) == 0
    _same_json(tmp_path / "t.json", tmp_path / "j.json")
    kept = sfm_io.read_sfm_data(str(tmp_path / "t.json")).n_points
    assert sfmd.n_points < kept < aug.n_points
