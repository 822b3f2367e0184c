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


def _offer(top, d, i, p):
    """grid_query.cuh TopMK::offer on a list of M [d, idx, pl] slots
    (empty: [BIG, -1, -1]), keys compared as (distance, index)."""
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


def _lane_model(d_row, pl_row, M, G):
    """K2's cooperative query: entry i goes to lane i % G, each lane
    offers its entries in order to a partial top-M, and the lanes merge
    by xor rounds (offer the partner's slots into one's own)."""
    tops = []
    for lane in range(G):
        top = [[np.float32(td.BIG), -1, -1] for _ in range(M)]
        for i in range(lane, len(d_row), G):
            if d_row[i] < td.BIG:
                _offer(top, d_row[i], i, int(pl_row[i]))
        tops.append(top)
    off = G // 2
    while off:
        tops = [_merged(tops[lane], tops[lane ^ off]) for lane in range(G)]
        off //= 2
    return tops[0]


def _merged(mine, other):
    top = [list(s) for s in mine]
    for d, i, p in other:
        if p >= 0:
            _offer(top, d, i, p)
    return top


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


@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_k2_group_merge_equals_sequential_rule(M, G, monkeypatch):
    """The rule of K2's cooperative kernel (a partial top-M per lane over
    entries i = lane, lane + G, ..., keyed by (distance, i), merged by
    shuffles) picks what the plain twin's M argmin rounds and the JAX
    `detect_epipolar_correspondences` pick, on a grid full of ties and
    repeated polylines, with queries whose clamped 5x5 cells repeat.  The
    kernel runs G = 8; the rule holds for any power of two, shown at 32
    as well."""
    rng = np.random.default_rng(100 + 10 * M + G)
    g = _tie_grid(rng)
    Q = 160
    pts = np.stack([rng.integers(0, 8, Q) * 10 + 0.5,
                    rng.integers(0, 6, Q) * 10 + 0.5], 1).astype(np.float32)
    pts[:8] = [[0.5, 0.5], [79.5, 59.5], [-3.0, 30.0], [85.0, 2.0],
               [40.0, -7.0], [0.0, 61.0], [79.9, 0.1], [0.1, 59.9]]
    vert = rng.random(Q) < 0.5           # axis-parallel lines: x or y
    lines = np.zeros((Q, 3), np.float32)
    lines[vert, 0] = 1.0
    lines[vert, 2] = -(pts[vert, 0] + rng.integers(-3, 4, vert.sum()))
    lines[~vert, 1] = 1.0
    lines[~vert, 2] = -(pts[~vert, 1] + rng.integers(-3, 4, (~vert).sum()))
    radius = np.full(Q, 40.0, np.float32)
    seen = []
    real = td._topm_distinct

    def capture(*rows):
        seen.append([r.numpy() for r in rows[:6]])
        return real(*rows)

    monkeypatch.setattr(td, "_topm_distinct", capture)
    tr = td.epipolar_topm_query(
        torch.as_tensor(g), torch.zeros(Q, dtype=torch.int32),
        torch.as_tensor(pts), torch.as_tensor(lines),
        torch.as_tensor(radius), 10.0, M)
    (pl_all, d_all, seg_all, t_all, x_all, y_all), = seen
    ties = 0
    for q in range(Q):
        top = _lane_model(d_all[q], pl_all[q], M, G)
        cand = d_all[q][d_all[q] < td.BIG]
        ties += len(cand) - len(np.unique(cand))
        for j, (d, i, p) in enumerate(top):
            assert tr.pl_id[q, j] == p
            assert tr.valid[q, j] == (p >= 0)
            if p >= 0:                     # the same entry's fields
                assert tr.dist[q, j] == d
                assert tr.seg[q, j] == seg_all[q, i]
                assert tr.t[q, j] == t_all[q, i]
                assert tr.xy[q, j, 0] == x_all[q, i]
                assert tr.xy[q, j, 1] == y_all[q, i]
    assert ties > Q                       # the scene forces equal distances
    assert (tr.valid.sum(1) == M).sum() > Q // 8   # full top-M lists
    jr = jax.vmap(lambda p, l, r: jd.detect_epipolar_correspondences(
        jnp.asarray(g[0]), p, l, 10.0, r, M))(
        jnp.asarray(pts), jnp.asarray(lines), jnp.asarray(radius))
    _compare(jr, tr)
