"""Seeding and following (kernels K1-K4 via their plain twins on the CPU)
against the JAX stage-3 seeding and `follow_seeds_bidirectional`.

Both packages get the same context (the JAX MatchingContext's arrays
through `context_from_arrays`).  Seeds must match seed for seed; the
follow is run from the seeds JAX's `_seed_from_starts` produced, and
per-step outputs are compared on live slots only (the JAX walk keeps
writing dead lanes' slots).  Tolerance: seed ids, chosen permutations,
directions, step counts and live masks identical; 2D coordinates within
2e-5 relative (epipolar lines come from a 3x3 contraction that XLA sums
in another order, and a crossing amplifies that by 1/sin(angle)), 3D
points within 1e-4 relative, segment parameters t within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import following as jf
from edgegraph3d_tpu.matching import refpoints as jr
from edgegraph3d_tpu.plgs.extraction import extract_plgs
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.matching import following as tf
from edgegraph3d_tpu_torch.matching import matches as tm
from edgegraph3d_tpu_torch.matching import refpoints as tr

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=16)


@pytest.fixture(scope="module")
def setup():
    sfmd, imgs, _ = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    jcfg = EdgeGraphConfig().replace(**KW)
    jctx = jr.build_context(sfmd, extract_plgs(imgs, jcfg), jcfg)
    tctx = tr.context_from_arrays(
        jctx.plg_coords, jctx.plg_length, jctx.grids, jctx.P_mats,
        jctx.F_table, jctx.cell, TConfig().replace(**KW), "cpu")
    seeds_np, seed_ref = jr.compute_seeds(sfmd, jctx, max_starting_views=2)
    return sfmd, jctx, tctx, seeds_np, seed_ref


def test_seeds_match_jax(setup):
    sfmd, _, tctx, seeds_np, seed_ref = setup
    obs_xy, obs_mask = tr.dense_observations(sfmd)
    sm = tr._start_mask(obs_mask, 2)
    got = tr.compute_seeds_chunk(tctx, torch.as_tensor(obs_xy),
                                 torch.as_tensor(obs_mask),
                                 torch.as_tensor(sm))
    assert len(seed_ref) > 20
    np.testing.assert_array_equal(got["ridx"].numpy(), seed_ref)
    for k in ("cams", "pl_id", "seg"):
        np.testing.assert_array_equal(got[k].numpy(), seeds_np[k], k)
    for k in ("t", "xy"):
        np.testing.assert_allclose(got[k].numpy(), seeds_np[k], rtol=2e-5,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["X"].numpy(), seeds_np["X"], rtol=1e-4,
                               atol=1e-6)


def _seed_tuples(seeds_np):
    n = len(seeds_np["cams"])
    j = jf.SeedTuple(**{k: jnp.asarray(v) for k, v in seeds_np.items()},
                     valid=jnp.ones(n, bool))
    t = tf.SeedTuple(**{k: torch.as_tensor(v) for k, v in seeds_np.items()},
                     valid=torch.ones(n, dtype=torch.bool))
    return j, t


@pytest.mark.parametrize("max_steps", [16, 3])
def test_follow_bidirectional_matches_jax(setup, max_steps):
    _, jctx, tctx, seeds_np, _ = setup
    js, ts = _seed_tuples(seeds_np)
    jfwd, jbwd, _ = jf.follow_seeds_bidirectional(
        js, jctx.plg_coords, jctx.plg_length, jctx.P_mats, jctx.F_table,
        jctx.config, max_steps)
    tfwd, tbwd, _ = tf.follow_seeds_bidirectional(
        ts, tctx.plg_coords, tctx.plg_length, tctx.P_mats, tctx.F_table,
        tctx.config, max_steps)
    for j, t in ((jfwd, tfwd), (jbwd, tbwd)):
        assert int(np.asarray(j.gn_overflow).max()) == 0
        for f in ("valid", "n_steps", "perm", "dirs", "final_seg"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
        live = np.asarray(j.valid)
        assert live.any()
        np.testing.assert_allclose(t.obs_xy.numpy()[live],
                                   np.asarray(j.obs_xy)[live], rtol=2e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(t.X.numpy()[live], np.asarray(j.X)[live],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(t.final_t.numpy(),
                                   np.asarray(j.final_t), rtol=0, atol=1e-4)
    if max_steps == 3:
        assert (tfwd.n_steps.numpy() >= 3).any()     # truncated chains


def test_follow_fixed_configuration_matches_jax(setup):
    """Continuation rounds: direction-pinned walk from given perms/dirs."""
    _, jctx, tctx, seeds_np, _ = setup
    js, ts = _seed_tuples(seeds_np)
    rng = np.random.default_rng(1)
    n = len(seeds_np["cams"])
    perms = np.asarray([[0, 1, 2], [1, 0, 2], [2, 0, 1]], np.int32)
    perm = perms[rng.integers(0, 3, n)]
    dirs = rng.choice([-1, 1], (n, 3)).astype(np.int32)
    j = jf.follow_seeds(js, jctx.plg_coords, jctx.plg_length, jctx.P_mats,
                        jctx.F_table, jnp.int32(1), jctx.config, 8,
                        fixed_perm=jnp.asarray(perm),
                        fixed_dirs=jnp.asarray(dirs))
    t = tf.follow_seeds(ts, tctx.plg_coords, tctx.plg_length, tctx.P_mats,
                        tctx.F_table, torch.ones((), dtype=torch.int32),
                        tctx.config, 8, fixed_perm=torch.as_tensor(perm),
                        fixed_dirs=torch.as_tensor(dirs))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.final_seg.numpy(),
                                  np.asarray(j.final_seg))
    assert np.asarray(j.valid).any()


def test_pack_and_chunk_size_invariance(setup):
    """compute_and_follow_seeds gives the same seeds, rows and meta for
    two refpoint chunk sizes."""
    sfmd, _, tctx, _, _ = setup

    def flat(chunk):
        round0, n = tr.compute_and_follow_seeds(sfmd, tctx, chunk, 2)
        rows = np.concatenate([r for _, _, r, _ in round0])
        meta = np.concatenate([m for _, _, _, m in round0])
        refs = np.concatenate([c["_ref"] for _, c, _, _ in round0])
        return n, refs, meta, rows[np.lexsort(rows.T[::-1])]

    a = flat(1 << 20)
    b = flat(7)
    assert a[0] == b[0] > 0
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert len(a[3]) == len(b[3]) > 0


def test_sweep_seeds_from_seed_arrays_matches_precomputed(setup):
    """sweep_seeds from host seed arrays (the entry the other stages use),
    in chunks of 5 seeds, collects the same points, claims and chain
    orders as from compute_and_follow_seeds' precomputed round 0."""
    sfmd, _, tctx, _, _ = setup
    round0, n = tr.compute_and_follow_seeds(sfmd, tctx, None, 2)
    keys = ("cams", "pl_id", "seg", "t", "xy", "X")
    seeds_np = {k: np.concatenate([c[k] for _, c, _, _ in round0])
                for k in keys}
    seed_ref = np.concatenate([c["_ref"] for _, c, _, _ in round0])
    lengths = tctx.plg_length.numpy()
    a = tr.sweep_seeds(None, None, tctx, tm.MatchesManager(lengths),
                       precomputed=round0)
    b = tr.sweep_seeds(seeds_np, seed_ref, tctx, tm.MatchesManager(lengths),
                       seed_chunk=5)
    assert n == len(seed_ref) > 5 and len(a[0]) > 20
    oa = np.lexsort((a[5], a[4]))
    ob = np.lexsort((b[5], b[4]))
    for i in (2, 3, 4, 5):
        np.testing.assert_array_equal(a[i][oa], b[i][ob])
    for i in (0, 1):
        np.testing.assert_allclose(a[i][oa], b[i][ob], rtol=1e-6, atol=1e-6)
