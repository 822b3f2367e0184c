"""Uniform segment grids over the image plane.

Port of edgegraph3d_tpu/matching/grid.py: the host-side builder below is
copied as is; the device lookups are torch (the plain path under the
K1/K2 kernels of detection.py).

TPU-native replacement for the reference's `PolyLine2DMap[Search]`
(reference: src/edgegraph3d/matching/plg_matching/polyLine_2d_map.cpp:40-58,
polyLine_2d_map_search.cpp:46-170): a per-view raster of grid cells, each
holding up to `capacity` (polyline_id, segment_idx) entries.  Unlike the
reference's per-polyline cell lists, storing *segments* keeps device
queries tiny: a lookup gathers 3x3 (or 5x5) neighborhoods of fixed-size
entry lists and computes point-segment / line-segment geometry on just
those endpoints — no full-polyline gathers.

Built host-side once per view (vectorized numpy), queried on device.
"""

from __future__ import annotations

import numpy as np
import torch

from edgegraph3d_tpu_torch.plgs.polyline_graph import PLGStack

BIG = 1e30


#: grid entry layout: (polyline_id, seg_idx, ax, ay, bx, by) as f32.
#: Carrying the segment ENDPOINTS in the entry makes every device query
#: a single contiguous per-cell gather — the earlier (pl, seg)-only
#: entries forced a second RANDOM 8-byte gather into coords[pl, seg]
#: per candidate (measured: the epipolar-correspondence kernel spent
#: ~6 s/chunk at full scale, dominated by exactly those reads).  ids
#: as f32 are exact below 2^24 (P <= 8192, L <= 64).
ENTRY_COLS = 6


def build_segment_grid(coords: np.ndarray, length: np.ndarray,
                       width: float, height: float, cell: float,
                       capacity: int) -> np.ndarray:
    """One view: coords [P,L,2], length [P] -> grid
    [GH,GW,capacity,ENTRY_COLS] f32 (pl, seg, ax, ay, bx, by), pl=-1
    padded.

    Every segment is sampled at cell/2 spacing so long (simplified)
    segments register in every cell they traverse (the reference
    rasterizes polylines into the cells their segments touch,
    polyLine_2d_map.cpp:40-58)."""
    GH = int(np.ceil(height / cell)) + 1
    GW = int(np.ceil(width / cell)) + 1
    P, L, _ = coords.shape
    seg_valid = (np.arange(L - 1)[None, :] < (length[:, None] - 1))
    pids, sids = np.nonzero(seg_valid)
    if len(pids) == 0:
        return np.full((GH, GW, capacity, ENTRY_COLS), -1.0,
                       dtype=np.float32)
    a = coords[pids, sids]
    b = coords[pids, sids + 1]
    seg_len = np.linalg.norm(b - a, axis=1)
    n_samp = np.maximum(np.ceil(seg_len / (cell * 0.5)).astype(np.int64) + 1, 2)

    # ragged expansion: sample each segment n_samp times
    total = int(n_samp.sum())
    seg_of_sample = np.repeat(np.arange(len(pids)), n_samp)
    # within-segment sample index 0..n_samp-1
    starts = np.concatenate([[0], np.cumsum(n_samp)[:-1]])
    within = np.arange(total) - np.repeat(starts, n_samp)
    t = within / np.repeat(np.maximum(n_samp - 1, 1), n_samp)
    pts = a[seg_of_sample] + t[:, None] * (b[seg_of_sample] - a[seg_of_sample])

    cx = np.clip((pts[:, 0] / cell).astype(np.int64), 0, GW - 1)
    cy = np.clip((pts[:, 1] / cell).astype(np.int64), 0, GH - 1)
    cell_id = cy * GW + cx
    entry = np.stack([pids[seg_of_sample], sids[seg_of_sample]], axis=1)

    # unique (cell, polyline, seg) then slot-assign per cell
    key = cell_id * (P * L * 2) + entry[:, 0] * L + entry[:, 1]
    uniq_idx = np.unique(key, return_index=True)[1]
    cell_id = cell_id[uniq_idx]
    entry = entry[uniq_idx]
    order = np.argsort(cell_id, kind="stable")
    cell_id = cell_id[order]
    entry = entry[order]
    # slot index within each cell
    first = np.concatenate([[True], cell_id[1:] != cell_id[:-1]])
    grp_start = np.flatnonzero(first)
    slot = np.arange(len(cell_id)) - np.repeat(
        grp_start, np.diff(np.concatenate([grp_start, [len(cell_id)]])))
    keep = slot < capacity

    grid = np.full((GH * GW, capacity, ENTRY_COLS), -1.0,
                   dtype=np.float32)
    ek = entry[keep]
    grid[cell_id[keep], slot[keep], 0:2] = ek
    grid[cell_id[keep], slot[keep], 2:4] = coords[ek[:, 0], ek[:, 1]]
    grid[cell_id[keep], slot[keep], 4:6] = coords[ek[:, 0], ek[:, 1] + 1]
    return grid.reshape(GH, GW, capacity, ENTRY_COLS)


def build_grids(stack: PLGStack, widths: np.ndarray, heights: np.ndarray,
                cell: float, capacity: int) -> np.ndarray:
    """All views -> [V, GH, GW, capacity, 2] (common GH/GW over views)."""
    W = float(np.max(widths))
    H = float(np.max(heights))
    grids = [build_segment_grid(stack.coords[v], stack.length[v], W, H,
                                cell, capacity)
             for v in range(stack.n_views)]
    return np.stack(grids)


# ----------------------------------------------------------------------
# Device-side lookups (plain torch; kernels K1/K2 do the same per thread)
# ----------------------------------------------------------------------

def cell_index(p: torch.Tensor, cell: float, n: int) -> torch.Tensor:
    """Grid cell of coordinates p: truncate toward zero, clip to
    [0, n-1]; NaN -> 0 and out-of-range values saturate (the CUDA
    conversion's semantics, made explicit before the cast)."""
    x = torch.nan_to_num(p / cell, nan=0.0)
    x = torch.clamp(x, -1.0, float(n))
    return torch.clamp(x.to(torch.int32), 0, n - 1)


def gather_neighborhood(grids: torch.Tensor, view: torch.Tensor,
                        pts: torch.Tensor, cell: float,
                        radius_cells: int = 1) -> torch.Tensor:
    """Entries of the (2r+1)^2 cells around each query point.

    grids [V,GH,GW,K,ENTRY_COLS], view [Q] int, pts [Q,2] ->
    [Q, (2r+1)^2 * K, ENTRY_COLS] in (cell row, cell column, slot) order,
    border cells repeated by the clip (invalid = pl column -1)."""
    _, GH, GW, K, C = grids.shape
    Q = pts.shape[0]
    cx = cell_index(pts[:, 0], cell, GW)
    cy = cell_index(pts[:, 1], cell, GH)
    offs = torch.arange(-radius_cells, radius_cells + 1, device=pts.device,
                        dtype=torch.int32)
    n = len(offs)
    ys = torch.clamp(cy[:, None] + offs, 0, GH - 1).long()
    xs = torch.clamp(cx[:, None] + offs, 0, GW - 1).long()
    v = view.long()[:, None, None]
    block = grids[v, ys[:, :, None], xs[:, None, :]]   # [Q,n,n,K,C]
    return block.reshape(Q, n * n * K, C)


def point_segment_distance(px, py, ax, ay, bx, by):
    """Point (px, py) [Q,1] against segments a->b [Q,C] ->
    (dist, t, qx, qy), component math in the kernels' order."""
    ux = bx - ax
    uy = by - ay
    denom = torch.clamp_min(ux * ux + uy * uy, 1e-12)
    t = torch.clamp(((px - ax) * ux + (py - ay) * uy) / denom, 0.0, 1.0)
    qx = ax + t * ux
    qy = ay + t * uy
    dx = px - qx
    dy = py - qy
    return torch.sqrt(dx * dx + dy * dy), t, qx, qy
