"""Kernels K1 / K2 (plain twins on the CPU) against the JAX detection.

The same grid and the same seeded queries go through the vmapped JAX
`detect_starting_intersections` / `detect_epipolar_correspondences` and
the port's `grid_topm_query` / `epipolar_topm_query`.  Queries include
points at and beyond the image border, where the clipped 3x3 / 5x5
neighbourhoods repeat cells.  Tolerance: pl_id, seg and valid identical;
t, xy and dist within 1e-5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import detection as jd
from edgegraph3d_tpu.matching.grid import build_grids
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.matching import detection as td
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs


@pytest.fixture(scope="module")
def grids():
    sfmd, imgs, _ = synthetic.make_scene(
        n_cams=4, n_refpoints_per_curve=8, width=320, height_px=240,
        focal=400.0, seed=3)
    stack = extract_plgs(imgs, EdgeGraphConfig().replace(
        max_polylines_per_view=256, max_polyline_len=64))
    return build_grids(stack, sfmd.widths, sfmd.heights, 10.0, 8), stack


def _queries(stack, n, seed):
    """Random points, points near polyline vertices, and border points."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-15.0, 335.0, (n, 2))
    verts = stack.coords[0][stack.length[0] >= 2][:, :8].reshape(-1, 2)
    k = min(n // 2, len(verts))
    pts[:k] = verts[:k] + rng.normal(0, 2.0, (k, 2))
    border = [[0, 0], [319.99, 239.99], [-4, 120], [330, 5], [160, -9],
              [5, 245], [0.5, 239.5], [319.5, 0.2]]
    pts[-len(border):] = border
    return pts.astype(np.float32)


def _compare(jr, tr):
    for f in ("pl_id", "seg", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)
    for f in ("t", "xy", "dist"):
        np.testing.assert_allclose(np.asarray(getattr(jr, f)),
                                   getattr(tr, f).numpy(), rtol=0,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("M", [1, 2, 4])
def test_grid_topm_matches_jax(grids, M):
    g, stack = grids
    pts = _queries(stack, 2000, M)
    for v in (0, 2):
        jr = jax.vmap(lambda p: jd.detect_starting_intersections(
            jnp.asarray(g[v]), p, 10.0, 10.0, M))(jnp.asarray(pts))
        view = torch.full((len(pts),), v, dtype=torch.int32)
        tr = td.grid_topm_query(torch.as_tensor(g), view,
                                torch.as_tensor(pts), 10.0, 10.0, M)
        _compare(jr, tr)
        assert tr.valid[:, 0].float().mean() > 0.05


@pytest.mark.parametrize("M,exclude", [(1, None), (2, 0.965), (4, None),
                                       (4, 0.965)])
def test_epipolar_topm_matches_jax(grids, M, exclude):
    g, stack = grids
    pts = _queries(stack, 2000, 10 + M)
    rng = np.random.default_rng(M)
    ang = rng.uniform(0, np.pi, len(pts))
    ab = np.stack([np.cos(ang), np.sin(ang)], 1)
    c = -(ab * pts).sum(1) + rng.normal(0, 4.0, len(pts))
    lines = np.concatenate([ab, c[:, None]], 1).astype(np.float32)
    radius = rng.uniform(2.0, 30.0, len(pts)).astype(np.float32)
    jr = jax.vmap(lambda p, l, r: jd.detect_epipolar_correspondences(
        jnp.asarray(g[1]), p, l, 10.0, r, M,
        exclude_parallel_cos=exclude))(jnp.asarray(pts), jnp.asarray(lines),
                                       jnp.asarray(radius))
    view = torch.ones(len(pts), dtype=torch.int32)
    tr = td.epipolar_topm_query(torch.as_tensor(g), view,
                                torch.as_tensor(pts), torch.as_tensor(lines),
                                torch.as_tensor(radius), 10.0, M, exclude)
    _compare(jr, tr)
    assert tr.valid[:, 0].any()


def test_single_view_wrappers_match_stack_form(grids):
    g, stack = grids
    pts = torch.as_tensor(_queries(stack, 300, 99))
    a = td.detect_starting_intersections(torch.as_tensor(g[3]), pts, 10.0,
                                         10.0, 4)
    b = td.grid_topm_query(torch.as_tensor(g),
                           torch.full((300,), 3, dtype=torch.int32), pts,
                           10.0, 10.0, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
