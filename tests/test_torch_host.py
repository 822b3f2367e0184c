"""The port's copied host modules give byte-identical results to the
JAX package's, plus the port's package-level precision pin.

Covered: PLG extraction (the C++ pass, on a scene and on images without
edges), build_grids, the SfM JSON round trip across the two packages,
and the density filter (the native pass against the JAX package's
filter, on its sequential and round-based paths).  Tolerance: none —
arrays must be equal.
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


@pytest.mark.parametrize("images", ["scene", "blank"])
def test_plg_extraction_identical(scenes, images):
    """The same stacks from both packages: on the scene's edge images,
    and on four 240x320 images without an edge pixel."""
    require_jax_native_lib()
    if images == "scene":
        (_, imgs, _), _ = scenes
    else:
        imgs = np.zeros((4, 240, 320), dtype=np.uint8)
    js = j_extract(imgs, EdgeGraphConfig().replace(**KW))
    ts = t_extract(imgs, TConfig().replace(**KW))
    np.testing.assert_array_equal(js.coords, ts.coords)
    np.testing.assert_array_equal(js.length, ts.length)
    assert js.overflow_dropped == ts.overflow_dropped
    if images == "scene":
        assert (ts.length >= 2).sum() > 10
    else:
        assert ts.coords.shape[0] == 4
        assert not ts.length.any() and ts.overflow_dropped == 0


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


def _random_case(N=600, V=5, dtype=np.float32):
    rng = np.random.default_rng(11)
    obs_xy = rng.uniform(0, 90, (N, V, 2)).astype(dtype)
    obs_mask = rng.random((N, V)) < 0.6
    obs_mask[:, 0] = True
    return obs_xy, obs_mask, 100, 100


def _empty_case():
    return np.zeros((0, 5, 2), np.float32), np.zeros((0, 5), bool), 100, 100


def _masked_rows_case():
    obs_xy, obs_mask, w, h = _random_case()
    obs_mask[::7] = False
    return obs_xy, obs_mask, w, h


def _border_case():
    """float32 coordinates on and just beside the 3 px cell borders."""
    edge = np.float32([0.0, 2.9999998, 3.0, 3.0000002, 5.9999995, 6.0,
                       8.999999, 9.0, 98.99999, 99.0, 100.0])
    x, y = np.meshgrid(edge, edge[::-1])
    obs_xy = np.stack([np.stack([x.ravel(), y.ravel()], -1),
                       np.stack([y.ravel(), x.ravel()], -1)], 1)
    obs_xy = np.concatenate([obs_xy, obs_xy[::-1]]).astype(np.float32)
    obs_mask = np.ones(obs_xy.shape[:2], bool)
    obs_mask[1::3, 0] = False
    return obs_xy, obs_mask, 100, 100


def _clip_case():
    """Negative coordinates and coordinates past width and height,
    quotients of 2^63 and more among them, which numpy's cast on x86
    turns into INT64_MIN and the clip into cell 0."""
    obs_xy, obs_mask, w, h = _random_case(N=400, V=4)
    rng = np.random.default_rng(12)
    far = np.float32([-1e30, -5e9, -7.0, -2.9, -0.5, 101.0, 150.0, 3e3,
                      5e9, 2.8e19, 1e30])
    pick = rng.random(obs_xy.shape) < 0.3
    obs_xy[pick] = rng.choice(far, int(pick.sum()))
    return obs_xy, obs_mask, w, h


def _nan_inf_case():
    """NaN and +-inf, both in masked slots and in observed ones."""
    obs_xy, obs_mask, w, h = _random_case(N=400, V=4)
    rng = np.random.default_rng(13)
    pick = rng.random(obs_xy.shape) < 0.15
    obs_xy[pick] = rng.choice(np.float32([np.nan, np.inf, -np.inf]),
                              int(pick.sum()))
    assert (pick.any(-1) & obs_mask).any() and (pick.any(-1) & ~obs_mask).any()
    return obs_xy, obs_mask, w, h


def _float64_case():
    obs_xy, obs_mask, w, h = _random_case(dtype=np.float64)
    obs_xy[:40, :, 0] = 3.0 * np.arange(1, 41)[:, None] - 2.0 ** -44
    obs_xy[40:80, :, 1] = 3.0 * np.arange(1, 41)[:, None]
    return obs_xy, obs_mask, w, h


def _non_contiguous_case():
    """Transposed views of [V, N, 2] and [V, N] arrays."""
    obs_xy, obs_mask, w, h = _random_case()
    obs_xy = np.ascontiguousarray(obs_xy.transpose(1, 0, 2)).transpose(1, 0, 2)
    obs_mask = np.ascontiguousarray(obs_mask.T).T
    assert not obs_xy.flags.c_contiguous and not obs_mask.flags.c_contiguous
    return obs_xy, obs_mask, w, h


def chain_tracks(N, V, width, height, seed, track=100, rep=6):
    """Overlapping chain-like tracks: `rep` jittered copies of each
    track of `track` points that step 0.3-1 px in every view, each slot
    observed with probability 0.4."""
    rng = np.random.default_rng(seed)
    T = -(-N // (track * rep))
    start = rng.uniform([0, 0], [width, height], (T, 1, 1, V, 2))
    ang = rng.uniform(0, 2 * np.pi, (T, 1, 1, V))
    step = np.stack([np.cos(ang), np.sin(ang)], -1) * \
        rng.uniform(0.3, 1.0, (T, 1, 1, V, 1))
    t = np.arange(track)[None, None, :, None, None]
    jit = rng.normal(0, 0.25, (T, rep, track, V, 2))
    obs_xy = (start + t * step + jit).reshape(-1, V, 2)[:N]
    return obs_xy.astype(np.float32), rng.random((N, V)) < 0.4


def _chains_case():
    """The benchmark cell's shape: 49 views at 1600x1200."""
    obs_xy, obs_mask = chain_tracks(20_000, 49, 1600, 1200, seed=3)
    return obs_xy, obs_mask, 1600, 1200


DENSITY_CASES = dict(
    random=_random_case, empty=_empty_case, masked_rows=_masked_rows_case,
    borders=_border_case, clip=_clip_case, nan_inf=_nan_inf_case,
    float64=_float64_case, non_contiguous=_non_contiguous_case,
    chains=_chains_case)


@pytest.mark.parametrize("jax_path", ["sequential", "rounds"])
@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_density_filter_identical(case, jax_path):
    """The native pass and the JAX package's filter, on its sequential
    loop and on its claim rounds, give the same keep mask.  JAX's filter
    casts NaN and +-inf to int64 and says so; the native pass spells
    that cast out."""
    obs_xy, obs_mask, w, h = DENSITY_CASES[case]()
    threshold = None if jax_path == "sequential" else 0
    native = t_density(obs_xy, obs_mask, w, h, cell=3)
    with np.errstate(invalid="ignore"):
        ref = j_density(obs_xy, obs_mask, w, h, cell=3,
                        sequential_threshold=threshold)
    assert native.dtype == bool and native.shape == (len(obs_xy),)
    np.testing.assert_array_equal(native, ref)
    if case in ("random", "chains"):
        assert 0 < native.sum() < len(obs_xy)
    if case == "masked_rows":
        assert not native[::7].any()


@pytest.mark.parametrize("dtype", [np.float16, np.int32, np.int64])
def test_density_filter_rejects_other_dtypes(dtype):
    obs_xy, obs_mask, w, h = _random_case()
    with pytest.raises(TypeError, match="float32 or float64"):
        t_density(obs_xy.astype(dtype), obs_mask, w, h)


@pytest.mark.parametrize("grid", [(100, 100, 0), (-1, 100, 3),
                                  (100, 3 * 2 ** 24, 3),
                                  (3 * 2 ** 16, 3 * 2 ** 16, 3)])
def test_density_filter_rejects_bad_grids(grid):
    """A cell under 1 px, a negative size, or a grid whose cells do not
    fit the native pass's 32-bit cell index."""
    obs_xy, obs_mask, _, _ = _random_case()
    with pytest.raises(ValueError, match="bad grid"):
        t_density(obs_xy, obs_mask, *grid)


def test_density_filter_empty_calls_no_library(monkeypatch):
    from edgegraph3d_tpu_torch import native

    def no_library():
        raise AssertionError("N = 0 called the native library")

    monkeypatch.setattr(native, "get_density_lib", no_library)
    keep = t_density(*_empty_case())
    assert keep.dtype == bool and keep.shape == (0,)


def test_precision_pinned():
    import edgegraph3d_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
