"""Nearby-polyline and epipolar-correspondence detection.

Port of edgegraph3d_tpu/matching/detection.py.  Two hand kernels:

  * K1 `grid_topm_query` (csrc/grid_topm.cu) — the closest points of the
    M nearest distinct polylines within a radius, from the 3x3 grid cells
    around each query (detect_starting_intersections); each 8-entry cell
    is loaded at once and each query's outputs stored as whole rows;
  * K2 `epipolar_topm_query` (csrc/epipolar_topm.cu) — crossings of each
    query's epipolar line with the segments of the 5x5 cells around its
    observation, within a per-query radius, top-M distinct polylines
    (detect_epipolar_correspondences).  A group of 8 lanes serves one
    query, and the queries are visited in a stable view-major order
    computed on the device (`_view_major_order`).

Both take a whole [V, GH, GW, K, 6] grid stack plus a per-query view
index, so one launch serves every view.  The plain-torch twins
(`_grid_topm_plain`, `_epipolar_topm_plain`) gather the neighbourhood
and select with `_topm_distinct`, the reference's M masked argmins; the
wrappers use them for CPU tensors only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.matching.grid import (BIG, gather_neighborhood,
                                                 point_segment_distance)

#: queries per block in the plain twins: bounds the [Q, cells*K, 6]
#: neighbourhood gather (25 cells x 8 x 6 floats = 4.8 KB per query)
PLAIN_BLOCK = 32768


class Candidates(NamedTuple):
    """Fixed-width per-query candidate lists (padded with valid=False)."""
    pl_id: torch.Tensor    # [Q, M] int32
    seg: torch.Tensor      # [Q, M] int32
    t: torch.Tensor        # [Q, M]
    xy: torch.Tensor       # [Q, M, 2]
    dist: torch.Tensor     # [Q, M]
    valid: torch.Tensor    # [Q, M] bool


def _topm_distinct(pl, dist, seg, t, x, y, M: int) -> Candidates:
    """The M closest candidates with distinct polyline ids per row of
    [Q, C] candidate arrays: M rounds of first-index argmin, each
    suppressing the chosen polyline."""
    d = dist
    cols = {k: [] for k in ("pl", "seg", "t", "x", "y", "d", "ok")}
    for _ in range(M):
        i = torch.argmin(d, dim=1, keepdim=True)
        di = d.gather(1, i)[:, 0]
        pli = pl.gather(1, i)[:, 0]
        cols["pl"].append(pli)
        cols["seg"].append(seg.gather(1, i)[:, 0])
        cols["t"].append(t.gather(1, i)[:, 0])
        cols["x"].append(x.gather(1, i)[:, 0])
        cols["y"].append(y.gather(1, i)[:, 0])
        cols["d"].append(di)
        cols["ok"].append((di < BIG / 2) & (pli >= 0))
        d = torch.where(pl == pli[:, None], BIG, d)
    ok = torch.stack(cols["ok"], 1)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    xy = torch.stack([torch.stack(cols["x"], 1), torch.stack(cols["y"], 1)],
                     -1)
    return Candidates(
        pl_id=torch.where(ok, torch.stack(cols["pl"], 1), -1),
        seg=torch.where(ok, torch.stack(cols["seg"], 1), 0),
        t=torch.where(ok, torch.stack(cols["t"], 1), zero),
        xy=torch.where(ok[..., None], xy, zero),
        dist=torch.where(ok, torch.stack(cols["d"], 1),
                         torch.full((), BIG, dtype=t.dtype,
                                    device=t.device)),
        valid=ok)


def _blocked(fn, Q: int, *args) -> Candidates:
    if Q <= PLAIN_BLOCK:
        return fn(*args)
    parts = [fn(*(a[lo:lo + PLAIN_BLOCK] for a in args))
             for lo in range(0, Q, PLAIN_BLOCK)]
    return Candidates(*[torch.cat(f) for f in zip(*parts)])


def _entries(grids, view, pts, cell, radius_cells):
    e = gather_neighborhood(grids, view, pts, cell, radius_cells)
    pl = e[..., 0].to(torch.int32)
    return (pl, e[..., 1].to(torch.int32), e[..., 2], e[..., 3], e[..., 4],
            e[..., 5])


def _grid_topm_plain(grids, view, pts, cell: float, radius: float,
                     M: int) -> Candidates:
    """Plain twin of K1."""
    def one(view, pts):
        pl, sg, ax, ay, bx, by = _entries(grids, view, pts, cell, 1)
        d, t, qx, qy = point_segment_distance(
            pts[:, 0:1], pts[:, 1:2], ax, ay, bx, by)
        d = torch.where((pl >= 0) & (d <= radius), d, BIG)
        return _topm_distinct(pl, d, sg, t, qx, qy, M)
    return _blocked(one, pts.shape[0], view, pts)


def _epipolar_topm_plain(grids, view, pts, lines, radius, cell: float,
                         M: int, exclude_parallel_cos: float | None = None
                         ) -> Candidates:
    """Plain twin of K2."""
    def one(view, pts, lines, radius):
        pl, sg, ax, ay, bx, by = _entries(grids, view, pts, cell, 2)
        l0, l1, l2 = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
        sa = ax * l0 + ay * l1 + l2
        sb = bx * l0 + by * l1 + l2
        diff = sa - sb
        parallel = diff.abs() < 1e-9
        s = torch.where(parallel, 0.0, sa / torch.where(parallel, 1.0, diff))
        crosses = (sa * sb <= 0.0) & ~parallel & (s >= 0.0) & (s <= 1.0)
        abx = bx - ax
        aby = by - ay
        if exclude_parallel_cos is not None:
            seg_len = torch.clamp_min(torch.sqrt(abx * abx + aby * aby),
                                      1e-12)
            cos = (abx * (-l1) + aby * l0).abs() / seg_len
            crosses = crosses & (cos < exclude_parallel_cos)
        x = ax + s * abx
        y = ay + s * aby
        ex = x - pts[:, 0:1]
        ey = y - pts[:, 1:2]
        d = torch.sqrt(ex * ex + ey * ey)
        d = torch.where((pl >= 0) & crosses & (d <= radius[:, None]), d, BIG)
        return _topm_distinct(pl, d, sg, s, x, y, M)
    return _blocked(one, pts.shape[0], view, pts, lines, radius)


def _empty_outputs(Q: int, M: int, device) -> Candidates:
    """Uninitialised outputs as views of three allocations: pl_id and seg
    of one int32 block, xy, t and dist of one float32 block (in that
    order), valid of one bool block.  Each field starts at a multiple of
    4 Q M bytes from its block's start, so K1's whole-row stores (16
    bytes at M = 4 and 8, 8 at M = 2) stay aligned."""
    n = Q * M
    ints = torch.empty(2 * n, dtype=torch.int32, device=device)
    flts = torch.empty(4 * n, dtype=torch.float32, device=device)
    return Candidates(
        pl_id=ints[:n].view(Q, M), seg=ints[n:].view(Q, M),
        t=flts[2 * n:3 * n].view(Q, M), xy=flts[:2 * n].view(Q, M, 2),
        dist=flts[3 * n:].view(Q, M),
        valid=torch.empty((Q, M), dtype=torch.bool, device=device))


def _out_ptrs(out: Candidates):
    return (out.pl_id.data_ptr(), out.seg.data_ptr(), out.t.data_ptr(),
            out.xy.data_ptr(), out.dist.data_ptr(), out.valid.data_ptr())


def _check_grid_args(grids, view, pts, align: int = 8):
    V, GH, GW, K, _ = grids.shape
    Q = pts.shape[0]
    kernels.require(grids, "grids", torch.float32, (V, GH, GW, K, 6),
                    align=align)
    kernels.require(view, "view", torch.int32, (Q,))
    kernels.require(pts, "pts", torch.float32, (Q, 2), align=8)
    return V, GH, GW, K, Q


def grid_topm_query(grids: torch.Tensor, view: torch.Tensor,
                    pts: torch.Tensor, cell: float, radius: float,
                    M: int, view_cycle: bool = False) -> Candidates:
    """Kernel K1.  grids [V,GH,GW,K,6] f32, view [Q] i32, pts [Q,2] f32
    -> top-M distinct polylines whose closest point lies within
    `radius` of each query point.  On the card, a grid of 8-entry cells
    (the cell-at-once body) must be 16-byte aligned: a misaligned one
    raises.  `view_cycle` says that the queries are rows of every view in
    order (view = arange(V).repeat(N)); the kernel then visits them view
    by view, which changes only its speed."""
    if pts.device.type == "cpu":
        return _grid_topm_plain(grids, view, pts, cell, radius, M)
    grids, view, pts = grids.contiguous(), view.contiguous(), \
        pts.contiguous()
    V, GH, GW, K, Q = _check_grid_args(grids, view, pts,
                                       align=16 if grids.shape[3] == 8 else 8)
    out = _empty_outputs(Q, M, pts.device)
    if Q == 0:
        return out
    n_rows = Q // V if view_cycle and Q % V == 0 else 0
    rc = kernels.lib().eg3d_grid_topm(
        grids.data_ptr(), V, GH, GW, K, view.data_ptr(), pts.data_ptr(), Q,
        float(cell), float(radius), M, n_rows, *_out_ptrs(out),
        kernels.stream_of(pts))
    kernels.check(rc, "grid_topm_query")
    kernels.LAUNCHES["grid_topm_query"] += 1
    return out


def _view_major_order(view, V: int):
    """[Q] int32: the queries in a stable order by view, computed on the
    device.  It only schedules K2's reads; every result is written at
    its query's own index.  (Ordering by grid cell within a view as well
    measured no faster on the H100, and its wider sort key costs three
    times the sort; PERF.md.)"""
    key = view.to(torch.int16 if V <= 2 ** 15 else torch.int32)
    return torch.argsort(key, stable=True).to(torch.int32)


def epipolar_topm_query(grids: torch.Tensor, view: torch.Tensor,
                        pts: torch.Tensor, lines: torch.Tensor,
                        radius: torch.Tensor, cell: float, M: int,
                        exclude_parallel_cos: float | None = None
                        ) -> Candidates:
    """Kernel K2.  grids [V,GH,GW,K,6] f32, view [Q] i32, pts [Q,2]
    observations, lines [Q,3] normalized epipolar lines, radius [Q] ->
    top-M distinct polylines crossing the line within the radius."""
    if pts.device.type == "cpu":
        return _epipolar_topm_plain(grids, view, pts, lines, radius, cell,
                                    M, exclude_parallel_cos)
    grids, view, pts, lines, radius = (
        t.contiguous() for t in (grids, view, pts, lines, radius))
    V, GH, GW, K, Q = _check_grid_args(grids, view, pts)
    kernels.require(lines, "lines", torch.float32, (Q, 3))
    kernels.require(radius, "radius", torch.float32, (Q,))
    out = _empty_outputs(Q, M, pts.device)
    if Q == 0:
        return out
    use = exclude_parallel_cos is not None
    order = _view_major_order(view, V)
    rc = kernels.lib().eg3d_epipolar_topm(
        grids.data_ptr(), V, GH, GW, K, view.data_ptr(), pts.data_ptr(),
        lines.data_ptr(), radius.data_ptr(), order.data_ptr(), Q,
        float(cell), M, 0, int(use),
        float(exclude_parallel_cos) if use else 0.0, *_out_ptrs(out),
        kernels.stream_of(pts))
    kernels.check(rc, "epipolar_topm_query")
    kernels.LAUNCHES["epipolar_topm_query"] += 1
    return out


def detect_starting_intersections(grid: torch.Tensor, pts: torch.Tensor,
                                  cell: float, starting_dist: float,
                                  M: int) -> Candidates:
    """One view's grid [GH,GW,K,6], queries pts [Q,2] (K1)."""
    view = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    return grid_topm_query(grid[None], view, pts, cell, starting_dist, M)


def detect_epipolar_correspondences(grid: torch.Tensor, pts: torch.Tensor,
                                    lines: torch.Tensor, cell: float,
                                    radius: torch.Tensor, M: int,
                                    exclude_parallel_cos: float | None = None
                                    ) -> Candidates:
    """One view's grid [GH,GW,K,6], queries pts [Q,2], lines [Q,3],
    radius [Q] (K2)."""
    view = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    return epipolar_topm_query(grid[None], view, pts, lines, radius, cell, M,
                               exclude_parallel_cos)
