"""The port's geometry (projection, F table, epipolar lines) against the
JAX `ops/geometry.py` on the same seeded inputs.

Tolerances: projections within 2e-7 of the image size (f32 rounding of
~1e3 px values); depths within 1e-6; the F table within 2e-4 per entry of
a unit-Frobenius matrix (the port builds it in float64 and rounds once,
JAX in float32 through a pseudo-inverse); line normals within 1e-6;
offsets within 1e-6 relative plus 5e-4 px, a few f32 ulps of the
largest term (~2,300 px) of the sum a*x + b*y + c, which the two sides
add in another order.  F[i, i] (a view against itself) is degenerate and
never read, so it is left out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.ops import geometry as jg
from edgegraph3d_tpu_torch.ops import geometry as tg


@pytest.fixture(scope="module")
def cams():
    return synthetic.ring_cameras(49, width=1600, height_px=1200,
                                  focal=2200.0)


def test_project_and_depth_match_jax(cams):
    rng = np.random.default_rng(0)
    X = rng.uniform(-0.6, 0.6, (300, 3)).astype(np.float32)
    P = cams.P.astype(np.float32)
    jxy, jz = jg.project_depth(jnp.asarray(P)[:, None], jnp.asarray(X)[None])
    txy, tz = tg.project_depth(torch.as_tensor(P)[:, None],
                               torch.as_tensor(X)[None])
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=0,
                               atol=2e-7 * 1600)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tg.project(torch.as_tensor(P)[:, None], torch.as_tensor(X)[None]),
        txy)


def test_fundamental_table_matches_jax(cams):
    Fj = np.asarray(jg.all_fundamental_matrices(
        jnp.asarray(cams.P, jnp.float32),
        jnp.asarray(cams.center, jnp.float32)))
    Ft = tg.all_fundamental_matrices(cams.P, cams.center)
    assert Ft.dtype == torch.float32 and Ft.shape == (49, 49, 3, 3)
    off = ~np.eye(49, dtype=bool)
    np.testing.assert_allclose(Ft.numpy()[off], Fj[off], rtol=0, atol=2e-4)


def test_epipolar_line_matches_jax(cams):
    rng = np.random.default_rng(1)
    others = np.arange(49) != 3
    F = tg.all_fundamental_matrices(cams.P, cams.center)[others, 3]
    x = rng.uniform(0, 1600, (48, 300, 2)).astype(np.float32)
    lj = np.asarray(jg.epipolar_line(jnp.asarray(F.numpy())[:, None],
                                     jnp.asarray(x)))
    lt = tg.epipolar_line(F[:, None], torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(lt[..., :2], lj[..., :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(lt[..., 2], lj[..., 2], rtol=1e-6, atol=5e-4)
    np.testing.assert_allclose(np.hypot(lt[..., 0], lt[..., 1]), 1.0,
                               rtol=0, atol=1e-6)
