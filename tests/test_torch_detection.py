"""Kernels K1 / K2 (plain twins on the CPU) against the JAX detection.

The same grid and the same seeded queries go through the vmapped JAX
`detect_starting_intersections` / `detect_epipolar_correspondences` and
the port's `grid_topm_query` / `epipolar_topm_query`.  Queries include
points at and beyond the image border, where the clipped 3x3 / 5x5
neighbourhoods repeat cells.  Tolerance: pl_id, seg and valid identical;
t, xy and dist within 1e-5 px.
"""

from functools import partial
from types import SimpleNamespace

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


def _offer(top, d, i, p):
    """common.cuh TopM<M>::offer on a list of M [d, idx, pl] slots
    (empty: [BIG, -1, -1]), keys compared as (distance, index): offered in
    increasing index, as K2 offers a query's entries, it keeps the
    earliest of equal distances, as TopM's strict `<` does."""
    M = len(top)
    same = [k for k in range(M) if top[k][2] == p]
    if same:
        k = same[0]
        if not (d, i) < (top[k][0], top[k][1]):
            return
        top[k] = [d, i, p]
    else:
        if not (d, i) < (top[M - 1][0], top[M - 1][1]):
            return
        top[M - 1] = [d, i, p]
    for k in range(M - 1, 0, -1):
        if (top[k][0], top[k][1]) < (top[k - 1][0], top[k - 1][1]):
            top[k], top[k - 1] = top[k - 1], top[k]


def _tie_grid(rng, GH=6, GW=8, Kc=8):
    """A random one-view grid with lattice endpoints, repeated polyline
    ids, empty slots and duplicated entries: many equal distances."""
    g = np.full((1, GH, GW, Kc, 6), -1.0, np.float32)
    n = GH * GW * Kc
    e = g.reshape(n, 6)
    e[:, 0] = rng.integers(0, 12, n)
    e[:, 1] = rng.integers(0, 4, n)
    cy, cx = np.divmod(np.arange(n) // Kc, GW)
    for c, base in ((2, cx), (3, cy), (4, cx), (5, cy)):
        e[:, c] = base * 10 + rng.integers(-6, 16, n)
    dup = rng.random(n) < 0.3
    e[dup] = e[rng.integers(0, n, dup.sum())]
    e[rng.random(n) < 0.2, 0] = -1
    return g


# ----------------------------------------------------------------------
# K2's shared-neighbourhood plan (csrc/epipolar_topm.cu), modelled
# ----------------------------------------------------------------------

#: queries a task of K2's wrapper body: one warp
K2_TASK = 32


def _cell_of(p, cell, n):
    """grid_query.cuh cell_of: p / cell in p's type, truncated toward
    zero (NaN -> 0, saturating), clamped to [0, n - 1]."""
    c = np.nan_to_num(p / np.asarray(cell, p.dtype), nan=0.0)
    return np.clip(np.trunc(np.clip(c, -2.0 ** 31, 2.0 ** 31 - 1)), 0,
                   n - 1).astype(np.int64)


def _slots(g, v, cy, cx):
    """The polyline id of every slot of the 5x5 neighbourhood of cell
    (cx, cy) on view v, in gather order (cell rows, cell columns, slots;
    cells clamped at the border)."""
    _, GH, GW, Kc, _ = g.shape
    ys = np.clip(cy + np.arange(-2, 3), 0, GH - 1)
    xs = np.clip(cx + np.arange(-2, 3), 0, GW - 1)
    return g[v][ys[:, None], xs[None, :], :, 0].reshape(25 * Kc)


def _staged(pl, NT):
    """The task's in-place compaction of the raw slots (their polyline
    ids `pl`, gather order) in rounds of NT lanes: each round reads its
    slots, then moves the non-empty ones (int(pl) >= 0, load_entry's
    test) down to the next free positions.  Returns the staged entries'
    gather indices."""
    st = list(range(len(pl)))
    n = 0
    for i0 in range(0, len(pl), NT):
        rnd = st[i0:i0 + NT]
        ne = [int(pl[i]) >= 0 for i in rnd]
        for r, i in enumerate(rnd):
            if ne[r]:
                st[n + sum(ne[:r])] = i
        n += sum(ne)
    return st[:n]


def _k2_model(g, view, pts, cell, order, n_rows, tile_rows, min_share,
              NT=K2_TASK):
    """K2's shared body as csrc/epipolar_topm.cu runs it on the wrapper's
    plan (order, or n_rows rows of every view visited view-major in tiles
    of tile_rows rows, detection.k2_plan): tasks of NT consecutive
    positions of the visiting order; in each, the first unserved query
    leads a group of every query of the task with its neighbourhood key
    (view, cell row, cell column); a group of at least min_share queries
    gets the neighbourhood staged (_staged) and offers it, a smaller one
    reads its slots itself (epipolar_topm_one).  Returns, per query, the
    gather indices it offers, in order, how often it was served, and
    each staging's (key, staged indices)."""
    Q = len(view)
    qs = np.arange(Q) if order is None else order
    if n_rows:                           # tiles of rows, view-major
        V, tr = Q // n_rows, tile_rows or n_rows
        qs = np.concatenate([(np.arange(lo, min(lo + tr, n_rows))[None, :]
                              * V + np.arange(V)[:, None]).reshape(-1)
                             for lo in range(0, n_rows, tr)])
    GH, GW, Kc = g.shape[1:4]
    key = np.stack([view, _cell_of(pts[:, 1], cell, GH),
                    _cell_of(pts[:, 0], cell, GW)], 1)
    offers, served, stagings = [None] * Q, np.zeros(Q, np.int64), []
    for j0 in range(0, Q, NT):
        lanes = qs[j0:j0 + NT]
        pending, solo = list(range(len(lanes))), []
        while pending:
            k = tuple(key[lanes[pending[0]]])
            grp = [r for r in range(len(lanes))
                   if tuple(key[lanes[r]]) == k]
            pending = [r for r in pending if r not in grp]
            if len(grp) < min_share:
                solo += grp
                continue
            st = _staged(_slots(g, *k), NT)
            stagings.append((k, st))
            for r in grp:
                offers[lanes[r]] = st
                served[lanes[r]] += 1
        for r in solo:
            pl = _slots(g, *key[lanes[r]])
            offers[lanes[r]] = [i for i in range(25 * Kc) if int(pl[i]) >= 0]
            served[lanes[r]] += 1
    return offers, served, stagings


def _k2_layout(rng, layout, V=3, GH=6, GW=8):
    """Queries on a tie grid stack of V views (k2 layouts): "seeding"
    (starts of refpoints x every view, start-major, every start of a
    refpoint carrying its point on a view; runs of 1 up to 70 queries,
    longer than a task; border, clamped and (0, 0) points) and
    "scattered" (a point a query: one-query runs)."""
    g = np.concatenate([_tie_grid(rng, GH, GW) for _ in range(V)])
    # each segment spans a power of two on both axes, so an axis-parallel
    # line's crossing and its distance come out exact in both frameworks
    # and equal distances stay equal (XLA's contractions cannot split a
    # tie)
    e = g.reshape(-1, 6)
    for c in (4, 5):
        e[:, c] = e[:, c - 2] + rng.choice([-1, 1], len(e)) \
            * 2.0 ** rng.integers(0, 5, len(e))
    dup = rng.random(len(e)) < 0.3
    e[dup] = e[rng.integers(0, len(e), dup.sum())]
    if layout == "seeding":
        n = np.array([1, 1, 2, 31, 33, 70, 3, 1, 5, 40])
        rp = np.stack([rng.integers(0, GW, (len(n), V)) * 10 + 0.5,
                       rng.integers(0, GH, (len(n), V)) * 10 + 0.5], -1)
        rp[0] = [[0.5, 0.5], [-3.0, 30.0], [85.0, 2.0]][:V]
        rp[1] = [[79.9, 0.1], [40.0, -7.0], [0.0, 61.0]][:V]
        rp[rng.random((len(n), V)) < 0.2] = 0.0
        pts = rp[np.repeat(np.arange(len(n)), n)].reshape(-1, 2)
    else:
        pts = np.stack([rng.integers(-1, GW + 1, 200 * V) * 10 + 0.5,
                        rng.integers(-1, GH + 1, 200 * V) * 10 + 0.5], 1)
    Q = len(pts)
    view = np.tile(np.arange(V), Q // V).astype(np.int32)
    vert = rng.random(Q) < 0.5           # axis-parallel lines: x or y
    lines = np.zeros((Q, 3), np.float32)
    lines[vert, 0] = 1.0
    lines[vert, 2] = -(pts[vert, 0] + rng.integers(-3, 4, vert.sum()))
    lines[~vert, 1] = 1.0
    lines[~vert, 2] = -(pts[~vert, 1] + rng.integers(-3, 4, (~vert).sum()))
    radius = rng.uniform(5.0, 40.0, Q // V).repeat(V).astype(np.float32)
    return g, view, pts.astype(np.float32), lines, radius


@partial(jax.jit, static_argnums=(4,))
def _jax_topm(grid, pts, lines, radius, M):
    return jax.vmap(lambda p, l, r: jd.detect_epipolar_correspondences(
        grid, p, l, 10.0, r, M))(pts, lines, radius)


@pytest.mark.parametrize("layout", ["seeding", "seeding shuffled",
                                    "scattered"])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_k2_shared_plan_serves_each_query_once(M, layout, monkeypatch):
    """K2's shared-neighbourhood plan, modelled on the wrapper's own plan
    (detection.k2_plan: view-major tiles by arithmetic for the seeding's
    layout, a sort by key for shuffled queries) with the wrapper's
    min_share and tiles, always staging (1, tiles of 7 rows) and never
    (33, one tile): every query served
    exactly once; every staging's entries are the non-empty slots of its
    neighbourhood in increasing gather index; the offers, under
    TopM<M>::offer's rule, pick what the plain version and JAX's
    detect_epipolar_correspondences pick, on a grid full of ties and
    repeated polylines, with runs longer than a task, one-query runs,
    border, clamped and (0, 0) points."""
    rng = np.random.default_rng(200 + 10 * M + len(layout))
    g, view, pts, lines, radius = _k2_layout(rng, layout.split()[0])
    Q = len(view)
    perm = rng.permutation(Q) if layout.endswith("shuffled") \
        else np.arange(Q)
    view, pts, lines, radius = (a[perm] for a in (view, pts, lines, radius))
    seen = []
    real = td._topm_distinct

    def capture(*rows):
        seen.append([r.numpy() for r in rows[:6]])
        return real(*rows)

    monkeypatch.setattr(td, "_topm_distinct", capture)
    tg, tv, tp = (torch.as_tensor(a) for a in (g, view, pts))
    tr = td.epipolar_topm_query(tg, tv, tp, torch.as_tensor(lines),
                                torch.as_tensor(radius), 10.0, M)
    (pl_all, d_all, seg_all, t_all, x_all, y_all), = seen
    order, n_rows = td.k2_plan(tg, tv, tp, 10.0, not layout.endswith(
        "shuffled"))
    assert (order is None) == (n_rows > 0)
    order = None if order is None else order.numpy()
    cand = [d[d < td.BIG] for d in d_all]
    assert sum(len(c) - len(np.unique(c)) for c in cand) > Q   # ties
    runs = []
    for min_share, tile_rows in ((td.K2_MIN_SHARE, td.K2_TILE_ROWS),
                                 (1, 7), (33, 0)):
        offers, served, stagings = _k2_model(g, view, pts, 10.0, order,
                                             n_rows, tile_rows, min_share)
        assert (served == 1).all()
        for k, st in stagings:
            pl = _slots(g, *k)
            assert st == [i for i in range(len(pl)) if int(pl[i]) >= 0]
        runs.append(len(stagings))
        for q in range(Q):
            top = [[np.float32(td.BIG), -1, -1] for _ in range(M)]
            for i in offers[q]:
                if d_all[q][i] < td.BIG:
                    _offer(top, d_all[q][i], i, int(pl_all[q][i]))
            for j, (d, i, p) in enumerate(top):
                assert tr.pl_id[q, j] == p
                assert tr.valid[q, j] == (p >= 0)
                if p >= 0:                 # the same entry's fields
                    assert tr.dist[q, j] == d
                    assert tr.seg[q, j] == seg_all[q, i]
                    assert tr.t[q, j] == t_all[q, i]
                    assert tr.xy[q, j, 0] == x_all[q, i]
                    assert tr.xy[q, j, 1] == y_all[q, i]
    assert runs[2] == 0 and runs[1] > 0   # 33: never staged; 1: always
    if layout != "scattered":             # runs shared by many queries
        assert runs[0] < Q // 4
    assert (tr.valid.sum(1) == M).sum() > Q // 16   # full top-M lists
    jr = {f: np.zeros(getattr(tr, f).shape, getattr(tr, f).numpy().dtype)
          for f in tr._fields}
    for v in range(g.shape[0]):
        sel = view == v
        out = _jax_topm(jnp.asarray(g[v]), jnp.asarray(pts[sel]),
                        jnp.asarray(lines[sel]), jnp.asarray(radius[sel]),
                        M)
        for f in tr._fields:
            jr[f][sel] = np.asarray(getattr(out, f))
    _compare(SimpleNamespace(**jr), tr)
