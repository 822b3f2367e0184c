"""The port's copied host modules give byte-identical results to the
JAX package's, plus the port's package-level precision pin.

Covered: PLG extraction (native twin), build_grids, the SfM JSON round
trip across the two packages, and the density filter (sequential and
round-based paths).  Tolerance: none — arrays must be equal.
"""

import json

import numpy as np
import pytest
import torch

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import sfm as j_sfm
from edgegraph3d_tpu.core import synthetic as j_syn
from edgegraph3d_tpu.filtering.density import density_filter as j_density
from edgegraph3d_tpu.matching.grid import build_grids as j_grids
from edgegraph3d_tpu.plgs.extraction import extract_plgs as j_extract
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.core import sfm as t_sfm
from edgegraph3d_tpu_torch.core import synthetic as t_syn
from edgegraph3d_tpu_torch.filtering.density import density_filter as \
    t_density
from edgegraph3d_tpu_torch.matching.grid import build_grids as t_grids
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs as t_extract
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=64)


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_cams=4, n_refpoints_per_curve=8, width=320, height_px=240,
              focal=400.0, seed=5)
    return j_syn.make_scene(**kw), t_syn.make_scene(**kw)


def test_synthetic_scene_identical(scenes):
    (js, ji, jc), (ts, ti, tc) = scenes
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(js.points, ts.points)
    np.testing.assert_array_equal(js.P, ts.P)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(a, b)


def test_plg_extraction_identical(scenes):
    require_jax_native_lib()
    (_, imgs, _), _ = scenes
    js = j_extract(imgs, EdgeGraphConfig().replace(**KW))
    ts = t_extract(imgs, TConfig().replace(**KW))
    np.testing.assert_array_equal(js.coords, ts.coords)
    np.testing.assert_array_equal(js.length, ts.length)
    assert js.overflow_dropped == ts.overflow_dropped
    assert (ts.length >= 2).sum() > 10


def test_build_grids_identical(scenes):
    (sfmd, imgs, _), _ = scenes
    stack = t_extract(imgs, TConfig().replace(**KW))
    a = j_grids(stack, sfmd.widths, sfmd.heights, 10.0, 8)
    b = t_grids(stack, sfmd.widths, sfmd.heights, 10.0, 8)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_sfm_json_round_trip_across_packages(scenes, tmp_path):
    (sfmd, _, _), _ = scenes
    j_sfm.write_sfm_data(sfmd, str(tmp_path / "j.json"))
    back = t_sfm.read_sfm_data(str(tmp_path / "j.json"))
    t_sfm.write_sfm_data(back, str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "j.json")) == \
        json.load(open(tmp_path / "t.json"))
    np.testing.assert_array_equal(back.points, sfmd.points)
    np.testing.assert_array_equal(back.P, sfmd.P)


@pytest.mark.parametrize("threshold", [None, 0])
def test_density_filter_identical(threshold):
    rng = np.random.default_rng(11)
    N, V = 600, 5
    obs_xy = rng.uniform(0, 90, (N, V, 2)).astype(np.float32)
    obs_mask = rng.random((N, V)) < 0.6
    obs_mask[:, 0] = True
    a = j_density(obs_xy, obs_mask, 100, 100, cell=3,
                  sequential_threshold=threshold)
    b = t_density(obs_xy, obs_mask, 100, 100, cell=3,
                  sequential_threshold=threshold)
    np.testing.assert_array_equal(a, b)
    assert 0 < b.sum() < N


def test_precision_pinned():
    import edgegraph3d_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
