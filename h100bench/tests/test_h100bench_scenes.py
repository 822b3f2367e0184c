"""The benchmark's copy of the scene generator gives the port's arrays."""

import numpy as np
import pytest

from edgegraph3d_tpu_torch.core import synthetic
from h100bench import scenes

SMALL = dict(n_cams=8, n_refpoints=500, width=400, height_px=300,
             focal=550.0)


def same(a, b, edges):
    assert np.array_equal(a.edge_images, edges)
    for k in ("K", "R", "t", "center", "widths", "heights", "points"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert len(a.obs_cam) == len(b.obs_cam)
    assert all(np.array_equal(x, y) for x, y in zip(a.obs_cam, b.obs_cam))
    assert all(np.array_equal(x, y) for x, y in zip(a.obs_xy, b.obs_xy))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 17])
def test_dtu_scale_scene_small(seed):
    b, edges, curves = synthetic.make_dtu_scale_scene(seed=seed, **SMALL)
    a = scenes.make_dtu_scale_scene(seed=seed, **SMALL)
    same(a, b, edges)
    assert all(np.array_equal(x, y) for x, y in zip(a.curves, curves))


@pytest.mark.parametrize("seed", [0, 1])
def test_dtu_scale_scene_full(seed):
    b, edges, _ = synthetic.make_dtu_scale_scene(seed=seed)
    same(scenes.make_dtu_scale_scene(seed=seed), b, edges)


def test_cube_scene():
    kw = dict(n_cams=8, n_refpoints_per_edge=48, width=1600,
              height_px=1200, focal=2200.0)
    b, edges, _ = synthetic.make_cube_scene(**kw)
    same(scenes.make_cube_scene(**kw), b, edges)


def test_make_by_name():
    a = scenes.make(dict(generator="dtu_scale", **SMALL), 3)
    b = scenes.make_dtu_scale_scene(seed=3, **SMALL)
    assert np.array_equal(a.edge_images, b.edge_images)


def test_refpoints_permuted_keeps_the_set():
    """With `content_seed`, the seed only orders the refpoints: the same
    curves, images, points and observations as the port's scene of that
    seed."""
    a = scenes.make_dtu_scale_scene(seed=5, content_seed=0, **SMALL)
    b = scenes.make_dtu_scale_scene(seed=6, content_seed=0, **SMALL)
    c = scenes.make_dtu_scale_scene(seed=0, **SMALL)
    assert np.array_equal(a.edge_images, c.edge_images)
    assert not np.array_equal(a.points, b.points)
    for s in (a, b):
        key = {tuple(p): (cam.tolist(), xy.tolist())
               for p, cam, xy in zip(s.points, s.obs_cam, s.obs_xy)}
        want = {tuple(p): (cam.tolist(), xy.tolist())
                for p, cam, xy in zip(c.points, c.obs_cam, c.obs_xy)}
        assert key == want
    assert all(np.array_equal(x, y) for x, y in zip(a.curves, c.curves))
