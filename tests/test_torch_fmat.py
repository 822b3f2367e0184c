"""LMedS fundamental matrices (fmat_source="lmeds"): the port's
ops/geometry.py against the JAX package's, the LMedS table against the
exact one, and the pipeline with the LMedS table.

JAX draws the 8-point subsets with jax.random.categorical, which torch
cannot reproduce; the port draws its own (`lmeds_subsets`) and takes the
subsets as an argument, so parity tests feed it JAX's draws.  Noise-free
scenes tie many subsets at a median of ~0, so LMedS parity is held on a
scene with 0.5 px noise and 20% gross outliers; on clean scenes the
table is held against the exact table only.

Tolerances: the 8-point F within 1e-5 per entry of a unit-Frobenius
matrix, up to sign (the eigenvector's sign is arbitrary); Sampson
distances within 1e-5 relative; the median exact; LMedS with JAX's
subsets within 1e-4 per entry, up to sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.ops import geometry as jg
from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.core import synthetic as t_synthetic
from edgegraph3d_tpu_torch.matching import refpoints as t_ref
from edgegraph3d_tpu_torch.ops import geometry as tg
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
from test_torch_native import require_jax_native_lib

CFG = TConfig().replace(max_polylines_per_view=256, max_polyline_len=128,
                        max_follow_steps=64)


def _up_to_sign(got, ref, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    s = np.sign((got * ref).sum(axis=(-2, -1), keepdims=True))
    np.testing.assert_allclose(got * s, ref, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def pairs():
    """Correspondences of three view pairs of a 6-view scene with 0.5 px
    noise, 20% gross outliers (30-80 px) and a few masked-out rows,
    padded to one N: x1, x2 [3, N, 2] f32, mask [3, N], outlier [3, N]."""
    sfmd, _, _ = synthetic.make_scene(n_cams=6, n_refpoints_per_curve=24,
                                      width=320, height_px=240,
                                      focal=400.0, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for a, b in ((0, 2), (1, 4), (3, 5)):
        x1, x2 = [], []
        for pid in range(sfmd.n_points):
            cams = list(sfmd.obs_cam[pid])
            if a in cams and b in cams:
                x1.append(sfmd.obs_xy[pid][cams.index(a)])
                x2.append(sfmd.obs_xy[pid][cams.index(b)])
        x1 = np.array(x1) + rng.normal(0, 0.5, (len(x1), 2))
        x2 = np.array(x2) + rng.normal(0, 0.5, (len(x2), 2))
        bad = np.zeros(len(x1), bool)
        bad[rng.choice(len(x1), len(x1) // 5, replace=False)] = True
        x2[bad] += rng.uniform(30, 80, (bad.sum(), 2))
        out.append((x1, x2, bad))
    N = max(len(o[0]) for o in out) + 4
    x1 = np.zeros((3, N, 2), np.float32)
    x2 = np.zeros((3, N, 2), np.float32)
    mask = np.zeros((3, N), bool)
    outlier = np.zeros((3, N), bool)
    for k, (a, b, bad) in enumerate(out):
        x1[k, :len(a)], x2[k, :len(a)] = a, b
        mask[k, :len(a)] = True
        mask[k, 0] = False                       # a masked-out row
        outlier[k, :len(a)] = bad
    return x1, x2, mask, outlier


def test_fundamental_8point_matches_jax(pairs):
    x1, x2, mask, _ = pairs
    Fj, vj = jg.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2),
                                   jnp.asarray(mask))
    Ft, vt = tg.fundamental_8point(torch.as_tensor(x1), torch.as_tensor(x2),
                                   torch.as_tensor(mask))
    _up_to_sign(Ft, Fj, 1e-5)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(np.linalg.norm(Ft.numpy(), axis=(1, 2)), 1.0,
                               rtol=1e-6)
    assert np.abs(np.linalg.det(Ft.numpy().astype(np.float64))).max() < 1e-6
    few = torch.as_tensor(mask).clone()
    few[:, 8:] = False
    assert not tg.fundamental_8point(torch.as_tensor(x1),
                                     torch.as_tensor(x2), few)[1].any()


def test_sampson_and_median_match_jax(pairs):
    x1, x2, mask, _ = pairs
    F = np.asarray(jg.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2),
                                         jnp.asarray(mask))[0])
    dj = np.asarray(jg._sampson_sq(jnp.asarray(F), jnp.asarray(x1),
                                   jnp.asarray(x2)))
    dt = tg._sampson_sq(torch.as_tensor(F), torch.as_tensor(x1),
                        torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-9)
    # medians of odd, even, one and zero masked entries, with ties
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5, (6, 11)).astype(np.float32)
    m = rng.random((6, 11)) < 0.6
    m[0] = False
    m[1] = False
    m[1, 3] = True
    m[2, :4] = True
    m[2, 4:] = False
    got = tg._masked_median(torch.as_tensor(x), torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jg._masked_median(jnp.asarray(x), jnp.asarray(m))))


def _jax_subsets(mask, key, n_subsets=64):
    """JAX's own draws (ops/geometry.py fundamental_lmeds), moved to the
    port's [..., n_subsets, 8] layout."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9).astype(jnp.float32)
    keys = jax.random.split(key, n_subsets)
    subs = jax.vmap(lambda k: jax.random.categorical(
        k, logits, axis=-1, shape=(8,) + logits.shape[:-1]))(keys)
    return torch.as_tensor(np.moveaxis(np.asarray(subs), (0, 1), (-2, -1))
                           .astype(np.int64))


def test_fundamental_lmeds_with_jax_subsets(pairs):
    """One key per pair, as lmeds_fundamental_table vmaps them."""
    x1, x2, mask, outlier = pairs
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    Fj, vj = jax.vmap(lambda a, b, m, k: jg.fundamental_lmeds(a, b, m, k))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), keys)
    subs = torch.stack([_jax_subsets(mask[k], keys[k]) for k in range(3)])
    assert subs.shape == (3, 64, 8)
    Ft, vt = tg.fundamental_lmeds(torch.as_tensor(x1), torch.as_tensor(x2),
                                  torch.as_tensor(mask), subsets=subs)
    _up_to_sign(Ft, Fj, 1e-4)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    d2 = tg._sampson_sq(Ft, torch.as_tensor(x1), torch.as_tensor(x2))
    inl = mask & ~outlier
    assert np.median(d2.numpy()[inl]) < 0.5           # px^2, as JAX's test


def test_lmeds_own_subsets(pairs):
    """The port's draws: masked indices only, the same on every call,
    and robust to the outliers."""
    x1, x2, mask, outlier = pairs
    m = torch.as_tensor(mask)
    subs = tg.lmeds_subsets(m)
    assert subs.shape == (3, 64, 8)
    assert torch.gather(m, 1, subs.reshape(3, -1)).all()
    assert torch.equal(subs, tg.lmeds_subsets(m))
    F, valid = tg.fundamental_lmeds(torch.as_tensor(x1), torch.as_tensor(x2),
                                    m)
    assert valid.all()
    d2 = tg._sampson_sq(F, torch.as_tensor(x1), torch.as_tensor(x2)).numpy()
    assert np.median(d2[mask & ~outlier]) < 0.5
    few = torch.zeros_like(m)
    few[:, :9] = True
    assert not tg.fundamental_lmeds(torch.as_tensor(x1), torch.as_tensor(x2),
                                    few, n_subsets=4)[1].any()


def _epipolar_median(sfmd, F, i, j):
    obs_xy, obs_mask = t_ref.dense_observations(sfmd)
    m = obs_mask[:, i] & obs_mask[:, j]
    x1 = np.concatenate([obs_xy[m][:, i], np.ones((m.sum(), 1))], axis=1)
    x2 = np.concatenate([obs_xy[m][:, j], np.ones((m.sum(), 1))], axis=1)
    lines = x1 @ F.T
    ln = np.linalg.norm(lines[:, :2], axis=1)
    return np.median(np.abs(np.sum(lines * x2, axis=1)) / np.maximum(ln, 1e-9))


def test_lmeds_table_matches_exact_on_clean_scene(monkeypatch):
    """tests/test_fmat_ab.py's clean scene: both tables give epipolar
    lines within 0.5 px of the observations.  The chunk size changes
    only rounding (torch's f32 sums take their order from the batch
    shape; on a noise-free scene the inlier threshold of the refit is
    near 0, so a rounding can move an inlier): within 1e-3 per entry."""
    sfmd, _, _ = t_synthetic.make_scene(
        n_cams=5, n_refpoints_per_curve=30, width=320, height_px=240,
        focal=400.0, seed=1)
    F_ex = tg.all_fundamental_matrices(sfmd.P, sfmd.center).numpy()
    F_lm = t_ref.lmeds_fundamental_table(sfmd, CFG, device="cpu")
    assert F_lm.shape == (5, 5, 3, 3) and F_lm.dtype == torch.float32
    for i, j in [(0, 1), (1, 3), (2, 4), (4, 0)]:
        for F in (F_ex[i, j], F_lm[i, j].numpy()):
            assert _epipolar_median(sfmd, F, i, j) < 0.5, (i, j)
    monkeypatch.setattr(t_ref, "LMEDS_PAIR_CHUNK", 7)
    F_small = t_ref.lmeds_fundamental_table(sfmd, CFG, device="cpu")
    _up_to_sign(F_small.reshape(-1, 3, 3), F_lm.reshape(-1, 3, 3), 1e-3)


def test_lmeds_invalid_pairs_get_sentinel():
    """tests/test_fmat_ab.py:57: a pair below fmat_min_common_points
    common refpoints gets the no-crossing line (0, 0, 1)."""
    sfmd, _, _ = t_synthetic.make_scene(
        n_cams=4, n_refpoints_per_curve=4, width=320, height_px=240,
        focal=400.0, seed=1)
    for n in range(sfmd.n_points):
        keep = sfmd.obs_cam[n] != 3
        sfmd.obs_cam[n] = sfmd.obs_cam[n][keep]
        sfmd.obs_xy[n] = sfmd.obs_xy[n][keep]
    F = t_ref.lmeds_fundamental_table(sfmd, CFG, device="cpu").numpy()
    sentinel = [[0, 0, 0], [0, 0, 0], [0, 0, 1]]
    for a, b in ((0, 3), (3, 0), (3, 2)):
        np.testing.assert_array_equal(F[a, b], sentinel)
    assert not np.allclose(F[0, 1], sentinel)


@pytest.fixture(scope="module")
def cube():
    require_jax_native_lib()
    return t_synthetic.make_cube_scene(n_cams=8, n_refpoints_per_edge=8,
                                       width=320, height_px=240,
                                       focal=400.0, seed=7)


def test_epipolar_consumers_ignore_the_sign_of_f(cube):
    """The sign of an LMedS F is arbitrary (eigh), so no consumer may
    depend on it: stage 3 with every F negated gives the same points,
    bit for bit (crossing tests, quasi-parallel tests and distances use
    products or absolute values of the line coefficients)."""
    sfmd, imgs, _ = cube
    ctx = t_ref.build_context(sfmd, extract_plgs(imgs, CFG), CFG,
                              device="cpu")
    flipped = t_ref.context_from_arrays(
        ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
        -ctx.F_table.numpy(), ctx.cell, CFG, "cpu")
    a = t_ref.reconstruct_from_refpoints(sfmd, ctx, max_starting_views=2)
    b = t_ref.reconstruct_from_refpoints(sfmd, flipped, max_starting_views=2)
    assert len(a.X) > 50
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.obs_mask, b.obs_mask)
    np.testing.assert_array_equal(a.obs_xy, b.obs_xy)


def test_pipeline_with_lmeds_table(cube):
    """run_pipeline(fmat_source="lmeds"), default stages, on the noise-free
    cube: the LMedS table's points lie on the cube as the exact table's
    do, in a comparable number."""
    sfmd, imgs, curves = cube
    outs = {}
    for src in ("exact", "lmeds"):
        outs[src] = tp.run_pipeline(sfmd, imgs, CFG.replace(fmat_source=src),
                                    max_starting_views=2, device="cpu")
    n0 = sfmd.n_points
    n_ex, n_lm = outs["exact"].n_points - n0, outs["lmeds"].n_points - n0
    assert n_lm > 0.8 * n_ex > 20
    cc = np.concatenate(curves)
    X = outs["lmeds"].points[n0:]
    d = np.sqrt(((X[:, None] - cc[None]) ** 2).sum(-1)).min(1)
    assert np.median(d) < 0.01
