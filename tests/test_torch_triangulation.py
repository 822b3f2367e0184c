"""Kernel K3 (plain twin on the CPU) against the JAX DLT + Gauss-Newton.

Seeded noisy observations of known points go through JAX
`triangulate_dlt` / `gauss_newton_batched` and the port's
`triangulate_gn` (cameras as an index into P_mats) at O = 2, 3 and 49,
with random masks, gross outliers, and warm and cold starts.
Tolerance: valid identical; X within 1e-4 relative (plus 1e-6 abs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.ops import triangulation as jt
from edgegraph3d_tpu_torch.ops import triangulation as tt


@pytest.fixture(scope="module")
def cams49():
    sfmd = synthetic.ring_cameras(49, width=1600, height_px=1200,
                                  focal=2200.0)
    return sfmd.P.astype(np.float32)


def _problem(P, N, O, seed, mask_p=0.8):
    rng = np.random.default_rng(seed)
    V = len(P)
    X = rng.uniform(-0.6, 0.6, (N, 3))
    cams = np.stack([rng.permutation(V)[:O] for _ in range(N)]) \
        .astype(np.int32)
    Pn = P.astype(np.float64)[cams]
    proj = np.einsum("noij,nj->noi", Pn,
                     np.concatenate([X, np.ones((N, 1))], 1))
    xy = proj[..., :2] / proj[..., 2:3] + rng.normal(0, 1.0, (N, O, 2))
    xy[rng.random(N) < 0.15, 0] += 30.0
    mask = rng.random((N, O)) < mask_p
    X0 = (X + rng.normal(0, 0.01, X.shape)).astype(np.float32)
    return cams, xy.astype(np.float32), mask, X0


def _jax(P, cams, xy, mask, X0, iters, accept):
    if cams.shape[1] > 8:
        # eager: compiling the 49-observation unrolled GN costs a minute
        with jax.disable_jit():
            return _jax_run(P, cams, xy, mask, X0, iters, accept)
    return _jax_run(P, cams, xy, mask, X0, iters, accept)


def _jax_run(P, cams, xy, mask, X0, iters, accept):
    Pg = jnp.asarray(P[cams])
    if X0 is None:
        X0 = jt.triangulate_dlt(Pg, jnp.asarray(xy), jnp.asarray(mask))
    X, mse, ok = jt.gauss_newton_batched(
        Pg, jnp.asarray(xy), jnp.asarray(mask), jnp.asarray(X0),
        max_iters=iters, accept_mse=accept, epsilon=5e-7)
    return np.asarray(X), np.asarray(mse), np.asarray(ok)


@pytest.mark.parametrize("O,warm,accept", [
    (2, False, 9.0), (3, False, 9.0), (3, True, 9.0), (3, False, 2.25),
    (49, True, 9.0)])
def test_triangulate_gn_matches_jax(cams49, O, warm, accept):
    cams, xy, mask, X0 = _problem(cams49, 512 if O < 49 else 256, O,
                                  seed=O * 7 + warm)
    X0 = X0 if warm else None
    iters = 8 if warm else 30
    jX, _, jok = _jax(cams49, cams, xy, mask, X0, iters, accept)
    tX, _, tok = tt.triangulate_gn(
        torch.as_tensor(cams49), torch.as_tensor(cams), torch.as_tensor(xy),
        torch.as_tensor(mask),
        X0=None if X0 is None else torch.as_tensor(X0), max_iters=iters,
        accept_mse=accept)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert 0 < jok.sum() < len(jok)
    np.testing.assert_allclose(tX.numpy()[jok], jX[jok], rtol=1e-4,
                               atol=1e-6)


def test_dlt_matches_jax(cams49):
    cams, xy, mask, _ = _problem(cams49, 512, 5, seed=3, mask_p=0.9)
    mask[:, :2] = True
    P = cams49[cams]
    a = np.asarray(jt.triangulate_dlt(jnp.asarray(P), jnp.asarray(xy),
                                      jnp.asarray(mask)))
    b = tt.triangulate_dlt(torch.as_tensor(P), torch.as_tensor(xy),
                           torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_add_observation_matches_jax(cams49):
    cams, xy, mask, X0 = _problem(cams49, 256, 4, seed=5)
    mask[:, 3] = False
    P = cams49[cams]
    new_P = cams49[(cams[:, 0] + 1) % 49]
    new_xy = xy[:, 0] + 0.5
    ja = jt.add_observation_to_3d_points(
        jnp.asarray(P), jnp.asarray(xy), jnp.asarray(mask),
        jnp.asarray(X0), jnp.asarray(new_P), jnp.asarray(new_xy))
    ta = tt.add_observation_to_3d_points(
        torch.as_tensor(P), torch.as_tensor(xy), torch.as_tensor(mask),
        torch.as_tensor(X0), torch.as_tensor(new_P), torch.as_tensor(new_xy))
    np.testing.assert_array_equal(ta[3].numpy(), np.asarray(ja[3]))
    np.testing.assert_array_equal(ta[2].numpy(), np.asarray(ja[2]))
    ok = np.asarray(ja[2])
    np.testing.assert_allclose(ta[0].numpy()[ok], np.asarray(ja[0])[ok],
                               rtol=1e-4, atol=1e-6)


def test_zero_observations_are_invalid(cams49):
    """O == 0 (the JAX code raises IndexError there): every point comes
    back invalid, with and without a warm start."""
    N = 5
    empty = dict(cams=torch.zeros((N, 0), dtype=torch.int32),
                 xy=torch.zeros((N, 0, 2)),
                 mask=torch.zeros((N, 0), dtype=torch.bool))
    for X0 in (None, torch.ones((N, 3))):
        X, mse, ok = tt.triangulate_gn(torch.as_tensor(cams49), **empty,
                                       X0=X0)
        assert X.shape == (N, 3) and not ok.any()
