"""Nearby-polyline and epipolar-correspondence detection.

Port of edgegraph3d_tpu/matching/detection.py.  Two hand kernels:

  * K1 `grid_topm_query` (csrc/grid_topm.cu) — the closest points of the
    M nearest distinct polylines within a radius, from the 3x3 grid cells
    around each query (detect_starting_intersections); each 8-entry cell
    is loaded at once and each query's outputs stored as whole rows;
  * K2 `epipolar_topm_query` (csrc/epipolar_topm.cu) — crossings of each
    query's epipolar line with the segments of the 5x5 cells around its
    observation, within a per-query radius, top-M distinct polylines
    (detect_epipolar_correspondences).  A warp takes 32 consecutive
    queries of a visiting order in which queries that read the same
    5x5 neighbourhood sit side by side (`k2_plan`), stages each
    neighbourhood its queries share once in shared memory, and every
    query tests the staged entries; each query's row is written whole.

Both take a whole [V, GH, GW, K, 6] grid stack plus a per-query view
index, so one launch serves every view.  The plain-torch twins
(`_grid_topm_plain`, `_epipolar_topm_plain`) gather the neighbourhood
and select with `_topm_distinct`, the reference's M masked argmins; the
wrappers use them for CPU tensors only.

Types.  The grid is f32.  K1's outputs take its query points' type (f32,
or f64 when chain extension re-anchors f64 projections); K2's take the
type its lines, points and radii promote to, with f64 lines over f32
points (the stage-3 seeding in f64) a body of its own.  Each kernel has
an f32 and an f64 instantiation (kernels.py).
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


def _empty_outputs(Q: int, M: int, device,
                   dtype=torch.float32) -> Candidates:
    """Uninitialised outputs as views of three allocations: pl_id and seg
    of one int32 block, xy, t and dist of one `dtype` block (in that
    order), valid of one bool block.  Each field starts at a multiple of
    4 Q M bytes (8 Q M for f64) from its block's start, so K1's
    whole-row stores (16 bytes at M = 4 and 8, 8 at M = 2; f64 rows in
    16-byte pieces) stay aligned."""
    n = Q * M
    ints = torch.empty(2 * n, dtype=torch.int32, device=device)
    flts = torch.empty(4 * n, dtype=dtype, device=device)
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
    kernels.require(pts, "pts", pts.dtype, (Q, 2),
                    align=2 * pts.element_size())
    return V, GH, GW, K, Q


def grid_topm_query(grids: torch.Tensor, view: torch.Tensor,
                    pts: torch.Tensor, cell: float, radius: float,
                    M: int, view_cycle: bool = False) -> Candidates:
    """Kernel K1.  grids [V,GH,GW,K,6] f32, view [Q] i32, pts [Q,2] f32
    or f64 -> top-M distinct polylines whose closest point lies within
    `radius` of each query point (t, xy, dist in pts' type).  On the
    card, a grid of 8-entry cells (the cell-at-once body) must be
    16-byte aligned: a misaligned one raises.  `view_cycle` says that
    the queries are rows of every view in order (view =
    arange(V).repeat(N)); the kernel then visits them view by view,
    which changes only its speed."""
    if pts.device.type == "cpu":
        return _grid_topm_plain(grids, view, pts, cell, radius, M)
    grids, view, pts = grids.contiguous(), view.contiguous(), \
        pts.contiguous()
    dt = kernels.require_float(pts.dtype, "grid_topm_query")
    V, GH, GW, K, Q = _check_grid_args(grids, view, pts,
                                       align=16 if grids.shape[3] == 8 else 8)
    out = _empty_outputs(Q, M, pts.device, dt)
    if Q == 0:
        return out
    n_rows = Q // V if view_cycle and Q % V == 0 else 0
    entry = "eg3d_grid_topm" if dt == torch.float32 else "eg3d_grid_topm_f64"
    with kernels.on_device(pts):
        rc = getattr(kernels.lib(), entry)(
            grids.data_ptr(), V, GH, GW, K, view.data_ptr(), pts.data_ptr(), Q,
            float(cell), float(radius), M, n_rows, *_out_ptrs(out),
            kernels.stream_of(pts))
    kernels.check(rc, "grid_topm_query")
    kernels.count_launch("grid_topm_query", dt)
    return out


#: K2's shared body stages a neighbourhood for a group of at least this
#: many of a warp's 32 queries; smaller groups read their cells alone
K2_MIN_SHARE = 2
#: the C entry's `body` of the shared-neighbourhood body
K2_SHARED_BODY = 0
#: rows of every view that K2 visits view-major at a time when the
#: queries are rows of every view (`view_cycle`): the tile's outputs stay
#: in L2 until their rows are whole (128 to 4,096 rows measured within
#: 10% of each other, 128 fastest, on an H100; PERF.md)
K2_TILE_ROWS = 128


def k2_plan(grids, view, pts, cell: float, view_cycle: bool):
    """K2's visiting order as (order or None, n_rows).  With `view_cycle`
    (the queries are N rows of every view: view = arange(V).repeat(N))
    the kernel visits them by arithmetic (n_rows = N, no order), in tiles
    of K2_TILE_ROWS rows, view-major within a tile: consecutive queries
    are then consecutive rows on one view, and the seeding's rows of one
    refpoint share an observation there.
    Else `order` is a stable device sort of the queries by neighbourhood
    key (view, cell row, cell column).  The order only schedules the
    kernel's work: each query reads its own inputs and writes its own
    row, and the kernel groups queries by the cells it computes itself,
    so a key that differs from the kernel's cell (a NaN point) costs
    sharing, never a result."""
    V, GH, GW = grids.shape[:3]
    Q = view.shape[0]
    if view_cycle and Q % V == 0:
        return None, Q // V
    c = torch.nan_to_num(pts / cell, nan=0.0).clamp(-1e9, 1e9).trunc()
    key = (view.long() * GH + c[:, 1].long().clamp(0, GH - 1)) * GW \
        + c[:, 0].long().clamp(0, GW - 1)
    if V * GH * GW <= 2 ** 31:
        key = key.to(torch.int32)
    return torch.argsort(key, stable=True).to(torch.int32), 0


def epipolar_topm_query(grids: torch.Tensor, view: torch.Tensor,
                        pts: torch.Tensor, lines: torch.Tensor,
                        radius: torch.Tensor, cell: float, M: int,
                        exclude_parallel_cos: float | None = None,
                        view_cycle: bool = False) -> Candidates:
    """Kernel K2.  grids [V,GH,GW,K,6] f32, view [Q] i32, pts [Q,2]
    observations, lines [Q,3] normalized epipolar lines, radius [Q] ->
    top-M distinct polylines crossing the line within the radius.  The
    outputs take the promoted type of lines, pts and radius: f32, or f64
    with f64 lines (pts f32 or f64; the radius is widened to f64, where
    the reference's comparison promotes it); f32 lines with f64 points
    have no instantiation and raise.  `view_cycle` says that the queries
    are rows of every view in order (view = arange(V).repeat(N)), which
    changes only the kernel's visiting order (`k2_plan`)."""
    if pts.device.type == "cpu":
        return _epipolar_topm_plain(grids, view, pts, lines, radius, cell,
                                    M, exclude_parallel_cos)
    grids, view, pts, lines, radius = (
        t.contiguous() for t in (grids, view, pts, lines, radius))
    dt = kernels.require_float(kernels.compute_dtype(pts, lines, radius),
                               "epipolar_topm_query")
    if pts.dtype not in (torch.float32, dt):
        raise TypeError(f"epipolar_topm_query: no kernel instantiation for "
                        f"{pts.dtype} points")
    V, GH, GW, K, Q = _check_grid_args(grids, view, pts)
    kernels.require(lines, "lines", dt, (Q, 3))
    radius = radius.to(dt)
    kernels.require(radius, "radius", dt, (Q,))
    out = _empty_outputs(Q, M, pts.device, dt)
    if Q == 0:
        return out
    use = exclude_parallel_cos is not None
    order, n_rows = k2_plan(grids, view, pts, cell, view_cycle)
    lib = kernels.lib()
    pts_arg = (pts.data_ptr(),) if dt == torch.float32 else \
        (pts.data_ptr(), int(pts.dtype == torch.float64))
    entry = lib.eg3d_epipolar_topm if dt == torch.float32 else \
        lib.eg3d_epipolar_topm_f64
    with kernels.on_device(pts):
        rc = entry(
            grids.data_ptr(), V, GH, GW, K, view.data_ptr(), *pts_arg,
            lines.data_ptr(), radius.data_ptr(), kernels.ptr(order),
            n_rows, K2_TILE_ROWS, Q, float(cell), M, K2_SHARED_BODY,
            K2_MIN_SHARE, int(use),
            float(exclude_parallel_cos) if use else 0.0, *_out_ptrs(out),
            kernels.stream_of(pts))
    kernels.check(rc, "epipolar_topm_query")
    kernels.count_launch("epipolar_topm_query", dt)
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
