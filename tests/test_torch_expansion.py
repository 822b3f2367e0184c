"""`expand_chains_compact` (on the CPU its plain version, the view loop
around K1 / K2 / K3's plain twins) against the JAX expansion on the same
swept chains, and the CPU-side contract of kernel K7 `expand_chains`.

The chains come from the JAX stage-3 sweep of a small cube scene; both
packages get the same context arrays.  The JAX call takes the padded
chunk layout the reference's expand_and_assemble builds, the port the
exact rows.
Tolerance: per-view acceptance masks identical; observations within
2e-5 relative; re-refined points within 1e-4 relative.  K7's contract
tests are exact (torch.equal).
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
from edgegraph3d_tpu_torch.ops import triangulation as tt
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=16)


@pytest.fixture(scope="module")
def swept():
    require_jax_native_lib()
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


def _layout(swept, T=64):
    """The swept chains in the chunk layout expand_and_assemble builds."""
    jctx, (X, obs3, cams3, _, seed_ids, orders) = swept
    gather, vld = je.group_chains(seed_ids, orders, max_t=T)
    kidx = np.flatnonzero(vld.reshape(-1))
    rows = gather.reshape(-1)[kidx]
    return dict(C=len(gather), vld=vld, X32=np.asarray(X, np.float32)[rows],
                o32=np.asarray(obs3, np.float32)[rows],
                cm=cams3[gather[:, 0]].astype(np.int32),
                ci=(kidx // T).astype(np.int32),
                ti=(kidx % T).astype(np.int32))


@pytest.mark.parametrize("mode", ["closest", "epipolar"])
def test_expand_chains_compact_matches_jax(swept, mode, monkeypatch):
    jctx = swept[0]
    T = 64
    lay = _layout(swept, T)
    C, vld, X32, o32, cm, ci, ti = (lay[k] for k in (
        "C", "vld", "X32", "o32", "cm", "ci", "ti"))
    n_k = len(ci)
    assert C > 5 and n_k > 50

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
    calls = []
    plain = te._expand_chains_compact_plain
    monkeypatch.setattr(te, "_expand_chains_compact_plain",
                        lambda *a: calls.append(1) or plain(*a))
    tX, toxy, tok = te.expand_chains_compact(
        tctx.plg_coords, tctx.grids, tctx.P_mats, tctx.F_table, tctx.cell,
        torch.as_tensor(X32), torch.as_tensor(o32), torch.as_tensor(cm),
        torch.as_tensor(ci), torch.as_tensor(ti),
        torch.ones(n_k, dtype=torch.bool), torch.as_tensor(vld),
        tctx.config, C, T, vld.sum(1))
    assert calls == [1]                 # the wrapper's CPU path is plain
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


def test_chain_slots_round_trip(swept):
    """K7's hand-off: every point lands in its own (chain, slot), padding
    rows (item_ok False, out-of-range ids as the JAX layout pads them)
    land nowhere, and the occupied slots are exactly chain_valid."""
    lay = _layout(swept)
    C, T, n_k = lay["C"], 64, len(lay["ci"])
    ci = torch.as_tensor(np.pad(lay["ci"], (0, 3), constant_values=C))
    ti = torch.as_tensor(np.pad(lay["ti"], (0, 3), constant_values=T))
    item_ok = torch.arange(n_k + 3) < n_k
    slots = te._chain_slots(ci, ti, item_ok, C, T)
    assert slots.shape == (C, T) and slots.dtype == torch.int32
    k = torch.arange(n_k)
    assert torch.equal(slots[ci[:n_k].long(), ti[:n_k].long()],
                       k.to(torch.int32))
    assert torch.equal(slots >= 0, torch.as_tensor(lay["vld"]))
    assert int((slots >= 0).sum()) == n_k


def test_gn_live_prefix_equals_padded(swept):
    """The exactness K7 relies on: the plain GN over 49 slots whose tail
    is masked (zeros, camera 0, as the plain loop's buffers hold them)
    gives bit-equal X, mse and valid to the same points trimmed to their
    live prefix, warm-started, 8 iterations."""
    jctx = swept[0]
    P = torch.as_tensor(np.array(jctx.P_mats, np.float32))
    V, O, N = P.shape[0], 49, 600
    rng = np.random.default_rng(11)
    X = np.asarray(swept[1][0], np.float64)
    X = X[rng.integers(0, len(X), N)] + rng.normal(0, 0.01, (N, 3))
    n_live = rng.integers(3, O + 1, N)
    cams = rng.integers(0, V, (N, O)).astype(np.int32)
    Pn = np.asarray(P, np.float64)[cams]
    proj = np.einsum("noij,nj->noi", Pn, np.concatenate([X, np.ones((N, 1))],
                                                          1))
    xy = proj[..., :2] / proj[..., 2:3] + rng.normal(0, 1.5, (N, O, 2))
    xy[rng.random(N) < 0.15, 0] += 25.0           # gross outliers: rejects
    mask = np.arange(O)[None, :] < n_live[:, None]
    cams[~mask] = 0
    xy[~mask] = 0.0
    X0 = torch.as_tensor((X + rng.normal(0, 0.02, X.shape)).astype(np.float32))
    cams_t = torch.as_tensor(cams)
    xy_t = torch.as_tensor(xy.astype(np.float32))
    args = (8, 5e-7, 9.0, 1e-5)
    Xp, msep, okp = tt._triangulate_gn_plain(P, cams_t, xy_t,
                                             torch.as_tensor(mask), X0, *args)
    assert okp.any() and not okp.all()
    for n in np.unique(n_live):
        r = torch.as_tensor(np.flatnonzero(n_live == n))
        Xl, msel, okl = tt._triangulate_gn_plain(
            P, cams_t[r, :n], xy_t[r, :n], torch.ones((len(r), n), dtype=bool),
            X0[r], *args)
        assert torch.equal(Xl, Xp[r]) and torch.equal(msel, msep[r]) \
            and torch.equal(okl, okp[r]), n


def test_plain_obs_mask_stays_prefix(swept, monkeypatch):
    """Slots fill in view order and are never freed: every mask the
    plain loop hands to the GN (the point's live slots plus the one
    being tried, the buffer an acceptance commits) is a prefix."""
    jctx = swept[0]
    lay = _layout(swept)
    tctx = tr.context_from_arrays(
        jctx.plg_coords, jctx.plg_length, jctx.grids, jctx.P_mats,
        jctx.F_table, jctx.cell, TConfig().replace(**KW), "cpu")
    masks = []
    gn = te.triangulate_gn
    monkeypatch.setattr(te, "triangulate_gn",
                        lambda P, c, xy, m, **kw: masks.append(m.clone())
                        or gn(P, c, xy, m, **kw))
    n_k = len(lay["ci"])
    te._expand_chains_compact_plain(
        tctx.plg_coords, tctx.grids, tctx.P_mats, tctx.F_table, tctx.cell,
        torch.as_tensor(lay["X32"]), torch.as_tensor(lay["o32"]),
        torch.as_tensor(lay["cm"]), torch.as_tensor(lay["ci"]),
        torch.as_tensor(lay["ti"]), torch.ones(n_k, dtype=torch.bool),
        torch.as_tensor(lay["vld"]), tctx.config, lay["C"], 64)
    assert len(masks) > 3
    for m in masks:
        n = m.sum(1, keepdim=True)
        assert torch.equal(m, torch.arange(m.shape[1])[None, :] < n)
        assert bool((n >= 4).all())
