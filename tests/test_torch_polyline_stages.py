"""Stages 1 and 2 of the port against the JAX package on the same inputs:
the sampling / crossing primitives, the match sets, the similarity edges
and the group seeds.

The port's context is built from the JAX context's arrays
(`context_from_arrays`), so both sides see the same polylines, grids and
F table.  Tolerances: discrete fields (segments, ids, cameras, valid
flags, match-set members) exact; positions within 1e-4 px, parameters
t within 1e-4 and 3D points within 1e-4 scene units (the cube spans
1.2): XLA and torch round the circle roots and lines in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import polyline_stages as jps
from edgegraph3d_tpu.matching import refpoints as jrp
from edgegraph3d_tpu.ops import polyline_ops as jpo
from edgegraph3d_tpu.plgs import extraction
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.matching import polyline_stages as tps
from edgegraph3d_tpu_torch.matching import refpoints as trp
from edgegraph3d_tpu_torch.ops import polyline_ops as tpo
from edgegraph3d_tpu_torch.ops.geometry import (epipolar_line,
                                                epipolar_line_fma)
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=64, closeness_max_dist_ratio=1e6)


def _random_polylines(rng, n, L):
    """Random-walk polylines [n, L, 2] with lengths covering 0, 1, 2 and
    L (padding slots hold junk, as real tables' do not matter)."""
    steps = rng.normal(0, 8.0, (n, L, 2)) + rng.normal(0, 6.0, (n, 1, 2))
    coords = (rng.uniform(40, 280, (n, 1, 2)) + np.cumsum(steps, 1))
    lengths = rng.integers(0, L + 1, n)
    lengths[:4] = [0, 1, 2, L]
    return coords.astype(np.float32), lengths.astype(np.int32)


def test_sample_interval_points_matches_jax():
    rng = np.random.default_rng(0)
    coords, lengths = _random_polylines(rng, 300, 16)
    fn = jax.vmap(lambda c, n: jpo.sample_interval_points(c, n, 20.0, 24))
    j = [np.asarray(a) for a in fn(jnp.asarray(coords),
                                   jnp.asarray(lengths))]
    t = [a.numpy() for a in tpo.sample_interval_points(
        torch.as_tensor(coords), torch.as_tensor(lengths), 20.0, 24)]
    for a, b in zip(t, j):                                # bit for bit
        np.testing.assert_array_equal(a, b)
    assert j[3][:, 1:].any() and not j[3][:2].any()       # lengths 0 and 1
    assert j[3][2, 0]                                     # length 2: first


def test_polyline_line_intersections_matches_jax():
    rng = np.random.default_rng(1)
    coords, lengths = _random_polylines(rng, 600, 16)
    ang = rng.uniform(0, np.pi, len(coords))
    ab = np.stack([np.cos(ang), np.sin(ang)], 1)
    anchor = coords[:, 3] + rng.normal(0, 10.0, (len(coords), 2))
    lines = np.concatenate([ab, -(ab * anchor).sum(1, keepdims=True)], 1)
    lines = lines.astype(np.float32)
    lines[4] = [1.0, 0.0, -float(coords[4, 0, 0])]    # through a vertex
    fn = jax.vmap(lambda c, n, l: jpo.polyline_line_intersections(
        c, n, l, 2))
    j = [np.asarray(a) for a in fn(jnp.asarray(coords),
                                   jnp.asarray(lengths),
                                   jnp.asarray(lines))]
    t = [a.numpy() for a in tpo.polyline_line_intersections(
        torch.as_tensor(coords), torch.as_tensor(lengths),
        torch.as_tensor(lines), 2)]
    np.testing.assert_array_equal(t[3], j[3])             # valid
    np.testing.assert_array_equal(t[1], j[1])             # seg, all slots
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-4)
    assert j[3][:, 1].any() and not j[3][:2].any()


@pytest.fixture(scope="module")
def ctxs():
    require_jax_native_lib()
    cfg = EdgeGraphConfig().replace(**KW)
    sfmd, imgs, _ = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    stack = extraction.extract_plgs(imgs, cfg)
    jctx = jrp.build_context(sfmd, stack, cfg)
    tctx = trp.context_from_arrays(
        jctx.plg_coords, jctx.plg_length, jctx.grids, jctx.P_mats,
        jctx.F_table, jctx.cell, TConfig().replace(**KW), "cpu")
    return sfmd, jctx, tctx


def _same_sets(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_closeness_match_sets_match_jax(ctxs):
    sfmd, jctx, tctx = ctxs
    _same_sets(tps.closeness_match_sets(sfmd, tctx),
               jps.closeness_match_sets(sfmd, jctx))


def test_similarity_match_sets_match_jax(ctxs):
    sfmd, jctx, tctx = ctxs
    _same_sets(tps.similarity_match_sets(sfmd, tctx),
               jps.similarity_match_sets(sfmd, jctx))


def test_similarity_edges_matmul_matches_host(ctxs):
    """The torch.matmul edge build (the card's path, f64 products)
    against the host clique build (the CPU path, f64 sums): the same
    nodes and edges in the same order, and the same f32 weights."""
    sfmd, _, tctx = ctxs
    u_h, e_h, w_h = tps.similarity_graph(sfmd, tctx, host=True)
    u_d, e_d, w_d = tps.similarity_graph(sfmd, tctx, host=False)
    assert len(e_h) > 1000
    np.testing.assert_array_equal(u_d, u_h)
    np.testing.assert_array_equal(e_d, e_h)
    np.testing.assert_array_equal(w_d, w_h)


@pytest.mark.parametrize("group_chunk", [64, 5])
def test_group_seeds_match_jax(ctxs, group_chunk):
    """Seed for seed, in the same order, whatever the port's chunk."""
    sfmd, jctx, tctx = ctxs
    groups = (jps.similarity_match_sets(sfmd, jctx)
              + jps.closeness_match_sets(sfmd, jctx))
    sj, gj = jps.seeds_from_match_sets(groups, jctx)
    st, gt = tps.seeds_from_match_sets(groups, tctx,
                                       group_chunk=group_chunk)
    assert len(gj) > 100
    np.testing.assert_array_equal(gt, gj)
    for k in ("cams", "pl_id", "seg"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    for k in ("t", "xy", "X"):
        np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_sweep(ctxs):
    """polyline_stages._group_seed_sweep of the JAX package up to its
    normalized lines, jitted as the sweep runs it, on the cube scene's
    match sets: the member rows and lengths, the interval samples
    (s_xy, s_seg, s_t, s_valid), the F pairs and the lines."""
    sfmd, jctx, _ = ctxs
    groups = (jps.similarity_match_sets(sfmd, jctx)
              + jps.closeness_match_sets(sfmd, jctx))
    cam, pl, msk = tps._member_table(groups, 8)

    @jax.jit
    def run(plg_coords, plg_length, F_table, grp_cam, grp_pl, grp_mask):
        cam_safe = jnp.maximum(grp_cam, 0)
        pl_safe = jnp.maximum(grp_pl, 0)
        coords = plg_coords[cam_safe, pl_safe]
        lengths = jnp.where(grp_mask, plg_length[cam_safe, pl_safe], 0)
        samples = jax.vmap(jax.vmap(lambda c, n: jpo.sample_interval_points(
            c, n, 20.0, 24)))(coords, lengths)
        s_xy = samples[0]
        xyh = jnp.concatenate([s_xy, jnp.ones(s_xy.shape[:-1] + (1,),
                                              s_xy.dtype)], -1)
        F_pair = F_table[cam_safe[:, :, None], cam_safe[:, None, :]]
        lines = jnp.einsum("gkjab,gksb->gksja", F_pair, xyh,
                           precision=jax.lax.Precision.HIGHEST)
        ln = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
        return (coords, lengths, samples, F_pair,
                lines / jnp.maximum(ln, 1e-20)[..., None])

    out = run(jctx.plg_coords, jctx.plg_length, jctx.F_table,
              jnp.asarray(cam), jnp.asarray(pl), jnp.asarray(msk))
    return jax.tree.map(np.array, out)


def test_sweep_lines_match_jax_bit_for_bit(jax_sweep):
    """The stage-1/2 sweep's epipolar lines, from JAX's own samples of
    the match-set members: `epipolar_line_fma` equals the JAX einsum +
    normalization of polyline_stages._group_seed_sweep bit for bit (the
    FMAs XLA's CPU code makes), where rounding every product does not."""
    _, _, (s_xy, _, _, _), F_pair, want = jax_sweep
    args = (torch.as_tensor(F_pair)[:, :, None],
            torch.as_tensor(s_xy)[:, :, :, None, :])
    got = epipolar_line_fma(*args).numpy()
    assert want.size > 10000
    np.testing.assert_array_equal(got, want)
    assert (epipolar_line(*args).numpy() != want).any()


def test_sweep_samples_match_jax_bit_for_bit(jax_sweep):
    """The sweep's interval samples of the match-set members, as the
    jitted JAX sweep makes them: the port's sample_interval_points equals
    them bit for bit, and so does each single step taken from JAX's
    previous sample (polyline_ops.advance_by_distance_xy takes the
    multiply-adds XLA's CPU code fuses)."""
    coords, lengths, want, _, _ = jax_sweep
    G, K, L, _ = coords.shape
    c = torch.as_tensor(coords).reshape(G * K, L, 2)
    n = torch.as_tensor(lengths).reshape(-1).to(torch.int32)
    got = tpo.sample_interval_points(c, n, 20.0, 24)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().reshape(b.shape), b)
    s_xy, s_seg = (torch.as_tensor(a).reshape(G * K, 24, *a.shape[3:])
                   for a in want[:2])
    alive = torch.as_tensor(want[3]).reshape(G * K, 24)
    fwd = torch.ones(G * K, dtype=torch.int32)
    for i in range(23):
        nxt = alive[:, i + 1]
        step = tpo.advance_by_distance(c, n, s_seg[:, i], s_xy[:, i], fwd,
                                       20.0)
        same = (step.xy == s_xy[:, i + 1]).all(1) \
            & (step.seg == s_seg[:, i + 1])
        assert bool(same[nxt].all()), i
    assert int(alive.sum()) > 400


def test_group_seed_follow_chunk_independent(ctxs):
    """The fused stage-1/2 phase (seeds + bidirectional follow): the same
    seeds as JAX's, and the same follows, rows and claim metadata at any
    group chunk (a seed's global index decides its claims), and the
    same follows as JAX's on every seed: the port samples and computes
    the sweep's epipolar lines with the multiply-adds XLA's CPU code
    fuses (test_sweep_samples_match_jax_bit_for_bit,
    test_sweep_lines_match_jax_bit_for_bit)."""
    sfmd, jctx, tctx = ctxs
    groups = (jps.similarity_match_sets(sfmd, jctx)
              + jps.closeness_match_sets(sfmd, jctx))
    r0j, nj = jps.group_seeds_and_follow(groups, jctx)
    r0a, na = tps.group_seeds_and_follow(groups, tctx)
    r0b, nb = tps.group_seeds_and_follow(groups, tctx, group_chunk=3)
    assert na == nb == nj > 100
    cat = lambda r0, f: np.concatenate([f(x) for x in r0])
    for k in ("_ref", "cams", "pl_id", "seg"):
        np.testing.assert_array_equal(cat(r0a, lambda x: x[1][k]),
                                      cat(r0j, lambda x: x[1][k]))
        np.testing.assert_array_equal(cat(r0b, lambda x: x[1][k]),
                                      cat(r0a, lambda x: x[1][k]))
    # rows sorted by (global seed, signed order): a chunk packs its fwd
    # rows before its bwd rows, and numbers seeds from its own start
    def rows(r0):
        r = cat(r0, lambda x: np.concatenate(
            [x[2][:, :9], x[2][:, 9:10] + x[0], x[2][:, 10:]], 1))
        return r[np.lexsort((r[:, 10], r[:, 9]))]
    np.testing.assert_array_equal(rows(r0b), rows(r0a))
    np.testing.assert_array_equal(cat(r0b, lambda x: x[3]),
                                  cat(r0a, lambda x: x[3]))

    # against JAX (its meta has one more column, the GN-overflow flag):
    # total / final seg / n_steps / perm / dirs per seed
    ma, mj = cat(r0a, lambda x: x[3]), cat(r0j, lambda x: x[3])[:, :39]
    disc = [0, 1, 2, 3, 7, 8, 9, 13, 14] + list(range(27, 39))
    flip = np.flatnonzero((ma[:, disc] != mj[:, disc]).any(1))
    assert len(flip) == 0, flip
    ok = np.setdiff1d(np.arange(len(ma)), flip)
    np.testing.assert_allclose(ma[ok][:, [4, 5, 6, 10, 11, 12]],
                               mj[ok][:, [4, 5, 6, 10, 11, 12]], rtol=0,
                               atol=1e-4)                       # final t
    for lo, n_col in ((15, 13), (21, 14)):                  # final xy, live
        live = ok[ma[ok, n_col] > 0]
        np.testing.assert_allclose(ma[live, lo:lo + 6], mj[live, lo:lo + 6],
                                   rtol=0, atol=1e-3)
    # the rows of the agreeing seeds: X within 1e-4, xy within 1e-3 px
    ra, rj = rows(r0a), rows(r0j)
    ra, rj = ra[~np.isin(ra[:, 9], flip)], rj[~np.isin(rj[:, 9], flip)]
    assert len(ra) == len(rj) > 1000
    np.testing.assert_array_equal(ra[:, 9:], rj[:, 9:])
    np.testing.assert_allclose(ra[:, :3], rj[:, :3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ra[:, 3:9], rj[:, 3:9], rtol=0, atol=1e-3)


def test_stage1_sweep_short_walks_match_jax(ctxs):
    """The stage-1 sweep with 4-step walks (every chain truncated and
    continued): the port's group seeds, follows and claims make as many
    points as the JAX package's, with the same chain identities."""
    import dataclasses

    from edgegraph3d_tpu.matching import matches as jm
    from edgegraph3d_tpu_torch.matching import matches as tm
    sfmd, jctx, tctx = ctxs
    jctx = dataclasses.replace(jctx, config=jctx.config.replace(
        max_follow_steps=4))
    tctx = dataclasses.replace(tctx, config=tctx.config.replace(
        max_follow_steps=4))
    groups = jps.similarity_match_sets(sfmd, jctx)
    r0j, _ = jps.group_seeds_and_follow(groups, jctx)
    r0t, _ = tps.group_seeds_and_follow(groups, tctx)
    lengths = np.asarray(jctx.plg_length)
    j = jrp.sweep_seeds(None, None, jctx, jm.MatchesManager(lengths),
                        precomputed=r0j)
    t = trp.sweep_seeds(None, None, tctx, tm.MatchesManager(lengths),
                        precomputed=r0t)
    assert len(t[0]) == len(j[0]) > 100
    oj, ot = np.lexsort((j[5], j[4])), np.lexsort((t[5], t[4]))
    for i in (2, 3, 4, 5):                # cams3, refs, seed ids, orders
        np.testing.assert_array_equal(np.asarray(t[i])[ot],
                                      np.asarray(j[i])[oj])
    np.testing.assert_allclose(np.asarray(t[0])[ot], np.asarray(j[0])[oj],
                               rtol=0, atol=1e-4)
