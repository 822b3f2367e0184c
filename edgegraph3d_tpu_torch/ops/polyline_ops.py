"""Polyline walk primitives, batched over lanes.

Port of the walk primitives of edgegraph3d_tpu/ops/polyline_ops.py
(advance_by_distance_xy, next_intersection_bounded_xy,
_segments_line_intersection_xy).  These are the plain path under kernel
K4 (following.follow_walk), which runs the same per-lane logic as a
sequential segment scan.

A position on a polyline is (seg, t, xy): point = lerp(coords[seg],
coords[seg + 1], t).  Direction is +1 (towards the end) or -1.  Every
function takes [S, L] coordinate rows px/py, [S] lengths (valid coord
counts), [S] positions and directions; "first event along the walk"
becomes a masked min (fwd) / max (bwd) over the segment axis, defaulting
to segment 0 when there is none, like the reference's argmin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e30


class Step(NamedTuple):
    seg: torch.Tensor      # [S] int32
    t: torch.Tensor        # [S]
    xy: torch.Tensor       # [S, 2]
    found: torch.Tensor    # [S] bool


def _first_in_walk_order(event: torch.Tensor, fwd: torch.Tensor):
    """event [S, K] bool, fwd [S] bool -> (index [S] long, any [S])."""
    K = event.shape[1]
    idx = torch.arange(K, device=event.device)
    first_f = torch.where(event, idx, K).amin(1)
    first_b = torch.where(event, idx, -1).amax(1)
    anyev = event.any(1)
    k = torch.where(fwd, first_f, first_b)
    return torch.where(anyev, k, 0), anyev


def _take(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return a.gather(1, k[:, None])[:, 0]


def advance_by_distance_xy(px, py, length, seg, xy, direction,
                           radius: float) -> Step:
    """The next point along the walk at euclidean distance `radius` from
    the current point: the first segment (in walk order, from `seg`)
    whose far end is at least `radius` away, then the circle-segment
    root in the walk direction."""
    L = px.shape[1]
    cx, cy = xy[:, 0:1], xy[:, 1:2]
    fx_all = px - cx
    fy_all = py - cy
    d2 = fx_all * fx_all + fy_all * fy_all                    # [S, L]
    r2 = radius * radius
    idx = torch.arange(L - 1, device=px.device)
    fwd = direction > 0
    far_d2 = torch.where(fwd[:, None], d2[:, 1:], d2[:, :-1])
    ahead = torch.where(fwd[:, None], idx >= seg[:, None],
                        idx <= seg[:, None])
    seg_valid = idx < (length[:, None] - 1)
    hit = ahead & seg_valid & (far_d2 >= r2)
    k, any_hit = _first_in_walk_order(hit, fwd)
    ax, ay = _take(px, k), _take(py, k)
    ux = _take(px, k + 1) - ax
    uy = _take(py, k + 1) - ay
    fx = ax - xy[:, 0]
    fy = ay - xy[:, 1]
    A = torch.clamp_min(ux * ux + uy * uy, 1e-12)
    B = 2.0 * (ux * fx + uy * fy)
    C = fx * fx + fy * fy - r2
    disc = torch.clamp_min(B * B - 4.0 * A * C, 0.0)
    sq = torch.sqrt(disc)
    s = torch.where(fwd, (-B + sq) / (2.0 * A), (-B - sq) / (2.0 * A))
    s = torch.clamp(s, 0.0, 1.0)
    xy_new = torch.stack([ax + s * ux, ay + s * uy], dim=-1)
    return Step(seg=k.to(torch.int32), t=s, xy=xy_new, found=any_hit)


def _segments_line_intersection_xy(ax, ay, bx, by, line, quasi_cos: float,
                                   quasi_dist: float):
    """Segments (ax,ay)->(bx,by) [S, K] against normalized lines [S, 3]
    -> (has [S, K], s [S, K], quasi [S, K])."""
    l0, l1, l2 = line[:, 0:1], line[:, 1:2], line[:, 2:3]
    sa = ax * l0 + ay * l1 + l2
    sb = bx * l0 + by * l1 + l2
    diff = sa - sb
    crosses = (sa * sb) <= 0.0
    parallel = diff.abs() < 1e-9
    s = torch.where(parallel, 0.0, sa / torch.where(parallel, 1.0, diff))
    ux = bx - ax
    uy = by - ay
    ulen = torch.clamp_min(torch.sqrt(ux * ux + uy * uy), 1e-12)
    cos = (-ux * l1 + uy * l0).abs() / ulen
    near = torch.minimum(sa.abs(), sb.abs()) <= quasi_dist
    quasi = (cos > quasi_cos) & near
    has = crosses & ~parallel & ~quasi
    return has, s, quasi


def next_intersection_bounded_xy(px, py, length, seg, t, xy, direction,
                                 line, min_dist: float, max_dist: float,
                                 quasi_cos: float = 0.965,
                                 quasi_dist: float = 5.0) -> Step:
    """First event of the walk against the epipolar line: a crossing
    (beyond t on the current segment) or a quasi-parallel segment.  Found
    iff the event is a crossing whose distance from the current point
    lies in [min_dist, max_dist]."""
    L = px.shape[1]
    idx = torch.arange(L - 1, device=px.device)
    ax, bx = px[:, :-1], px[:, 1:]
    ay, by = py[:, :-1], py[:, 1:]
    has, s, quasi = _segments_line_intersection_xy(
        ax, ay, bx, by, line, quasi_cos, quasi_dist)
    fwd = direction > 0
    seg_valid = idx < (length[:, None] - 1)
    ahead = torch.where(fwd[:, None], idx >= seg[:, None],
                        idx <= seg[:, None])
    on_cur = idx == seg[:, None]
    s_ok = torch.where(on_cur, torch.where(fwd[:, None], s >= t[:, None],
                                           s <= t[:, None]), True)
    event_i = has & ahead & seg_valid & s_ok
    event_q = quasi & ahead & seg_valid
    first, any_event = _first_in_walk_order(event_i | event_q, fwd)
    is_quasi = _take(event_q, first) & any_event
    sf = _take(s, first)
    axf, ayf = _take(ax, first), _take(ay, first)
    sx = axf + sf * (_take(bx, first) - axf)
    sy = ayf + sf * (_take(by, first) - ayf)
    ex = sx - xy[:, 0]
    ey = sy - xy[:, 1]
    dsq = ex * ex + ey * ey
    in_bounds = (dsq >= min_dist * min_dist) & (dsq <= max_dist * max_dist)
    found = any_event & ~is_quasi & in_bounds
    return Step(seg=first.to(torch.int32), t=sf,
                xy=torch.stack([sx, sy], dim=-1), found=found)
