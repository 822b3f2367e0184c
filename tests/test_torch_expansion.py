"""`expand_chains_compact` (K1 / K2 / K3 via their plain twins on the
CPU) against the JAX expansion on the same swept chains.

The chains come from the JAX stage-3 sweep of a small cube scene; both
packages get the same context arrays.  The JAX call takes the padded
chunk layout the reference's expand_and_assemble builds, the port the
exact rows.
Tolerance: per-view acceptance masks identical; observations within
2e-5 relative; re-refined points within 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import expansion as je
from edgegraph3d_tpu.matching import matches
from edgegraph3d_tpu.matching import refpoints as jr
from edgegraph3d_tpu.plgs.extraction import extract_plgs
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.matching import expansion as te
from edgegraph3d_tpu_torch.matching import refpoints as tr

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=16)


@pytest.fixture(scope="module")
def swept():
    sfmd, imgs, _ = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    jcfg = EdgeGraphConfig().replace(**KW)
    jctx = jr.build_context(sfmd, extract_plgs(imgs, jcfg), jcfg)
    round0, _ = jr.compute_and_follow_seeds(sfmd, jctx,
                                            max_starting_views=2)
    mgr = matches.MatchesManager(np.asarray(jctx.plg_length))
    res = jr.sweep_seeds(None, None, jctx, mgr, precomputed=round0)
    return jctx, res


@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_expand_chains_compact_matches_jax(swept, mode):
    jctx, (X, obs3, cams3, _, seed_ids, orders) = swept
    T = 64
    gather, vld = je.group_chains(seed_ids, orders, max_t=T)
    C = len(gather)
    kidx = np.flatnonzero(vld.reshape(-1))
    rows = gather.reshape(-1)[kidx]
    n_k = len(kidx)
    assert C > 5 and n_k > 50
    X32 = np.asarray(X, np.float32)[rows]
    o32 = np.asarray(obs3, np.float32)[rows]
    cm = cams3[gather[:, 0]].astype(np.int32)
    ci = (kidx // T).astype(np.int32)
    ti = (kidx % T).astype(np.int32)

    jcfg = jctx.config.replace(expand_correspondence_mode=mode)
    K = n_k + 3                                # padded rows, dropped
    jX, joxy, jok, _ = je.expand_chains_compact(
        jctx.plg_coords, jctx.grids, jctx.P_mats, jctx.F_table, jctx.cell,
        jnp.asarray(np.pad(X32, ((0, 3), (0, 0)))),
        jnp.asarray(np.pad(o32, ((0, 3), (0, 0), (0, 0)))), jnp.asarray(cm),
        jnp.asarray(np.pad(ci, (0, 3), constant_values=C)),
        jnp.asarray(np.pad(ti, (0, 3), constant_values=T)),
        jnp.asarray(np.arange(K) < n_k), jnp.asarray(vld), jcfg, C, T)
    tctx = tr.context_from_arrays(
        jctx.plg_coords, jctx.plg_length, jctx.grids, jctx.P_mats,
        jctx.F_table, jctx.cell, TConfig().replace(
            expand_correspondence_mode=mode, **KW), "cpu")
    tX, toxy, tok = te.expand_chains_compact(
        tctx.plg_coords, tctx.grids, tctx.P_mats, tctx.F_table, tctx.cell,
        torch.as_tensor(X32), torch.as_tensor(o32), torch.as_tensor(cm),
        torch.as_tensor(ci), torch.as_tensor(ti),
        torch.ones(n_k, dtype=torch.bool), torch.as_tensor(vld),
        tctx.config, C, T)
    jok = np.asarray(jok)[:n_k]
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum(1).max() > 3                 # views were added
    np.testing.assert_allclose(toxy.numpy()[jok],
                               np.asarray(joxy)[:n_k][jok], rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX)[:n_k], rtol=1e-4,
                               atol=1e-6)


def test_monotone_runs_matches_jax():
    rng = np.random.default_rng(4)
    C, T = 40, 24
    pl = rng.integers(0, 3, (C, T)).astype(np.int32)
    pos = np.cumsum(rng.choice([-1.0, 0.0, 1.0, 0.5], (C, T)), 1) \
        .astype(np.float32)
    ok = rng.random((C, T)) < 0.8
    valid = np.arange(T)[None, :] < rng.integers(1, T + 1, C)[:, None]
    a = je._monotone_runs(jnp.asarray(pl), jnp.asarray(pos), jnp.asarray(ok),
                          jnp.asarray(valid))
    b = te._monotone_runs(torch.as_tensor(pl), torch.as_tensor(pos),
                          torch.as_tensor(ok), torch.as_tensor(valid))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
