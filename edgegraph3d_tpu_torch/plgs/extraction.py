"""Edge image -> 2D polyline graph extraction.

TPU-native redesign of the reference's sequential pixel scans
(reference: src/edgegraph3d/io/input/convert_edge_images_pixel_to_segment.cpp):

  stage 1  corner-pixel cleanup      — vectorized stencil passes with
           (parity: ..._remove_useless_hubs, :294-343)   checkerboard
           phases instead of the row-major in-place scan
  stage 2  pixel adjacency           — shifted-mask edge construction;
           (parity: convertEdgeImagePixelToGraph_NoCycles, :347-426)
           redundant diagonals are suppressed directly (a diagonal link
           is added only when neither adjacent orthogonal pixel exists),
           which removes the 8-connectivity triangles the reference
           suppresses with its bounded is_connected(a,b,8) BFS
  stage 3  chain tracing             — parallel list ranking (pointer
           doubling) over directed half-edges, replacing the sequential
           walks (find_polyline*, :487-574); O(E log L) fully
           vectorized, same algorithm is expressible in JAX
  stage 4  graph optimization        — remove degenerate loops, merge
           degree-2 nodes, Douglas-Peucker simplify (tol 1 px),
           connect close extremes (<= 6 px, different components, no
           crossing), split long loops, smooth-length component filter
           (parity: PolyLineGraph2DHMapImpl::optimize order,
            polyline_graph_2d_hmap_impl.cpp:255-266)
"""

from __future__ import annotations

import os

import numpy as np

from edgegraph3d_tpu_torch.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu_torch.plgs.polyline_graph import (PLG2D, PLGStack,
                                                 from_polyline_list,
                                                 stack_plgs)


# ----------------------------------------------------------------------
# Stage 1: corner-pixel cleanup
# ----------------------------------------------------------------------

def _nbr(m: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Neighbor lookup image: out[i, j] = m[i+dy, j+dx] (False outside)."""
    H, W = m.shape
    out = np.zeros_like(m)
    ys = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(-dx, 0), W + min(-dx, 0))
    ys_src = slice(max(dy, 0), H + min(dy, 0))
    xs_src = slice(max(dx, 0), W + min(dx, 0))
    out[ys, xs] = m[ys_src, xs_src]
    return out


def remove_useless_corners(mask: np.ndarray) -> np.ndarray:
    """Clear redundant L-corner pixels — EXACT reference semantics.

    One sequential row-major scan over the (mutating) mask: a pixel
    with a vertical and a horizontal neighbor whose opposite diagonal
    is empty carries no connectivity and is cleared in place, affecting
    later pixels' decisions (parity:
    convertEdgeImagesPixelToNodesNoSquaresNoTriangles_remove_useless_hubs,
    convert_edge_images_pixel_to_segment.cpp:294-343, including its
    `i > 1` / `j > 1` bound guards).  The production reference path
    selects exactly this variant at :355 — the square/triangle
    collapse (:212-293) is a commented-out alternative there and is
    intentionally not used here either.

    Sparse Python loop over edge pixels (row-major, live reads) — the
    behavior-defining fallback; native/extraction.cpp is the fast
    identical path.
    """
    m = mask.copy()
    H, W = m.shape
    ys, xs = np.nonzero(m)          # np.nonzero scans row-major
    for i, j in zip(ys.tolist(), xs.tolist()):
        n = i > 0 and m[i - 1, j]
        s = i < H - 1 and m[i + 1, j]
        w = j > 0 and m[i, j - 1]
        e = j < W - 1 and m[i, j + 1]
        se = i < H - 1 and j < W - 1 and m[i + 1, j + 1]
        sw = i < H - 1 and j > 0 and m[i + 1, j - 1]
        ne = i > 0 and j < W - 1 and m[i - 1, j + 1]
        nw = i > 0 and j > 0 and m[i - 1, j - 1]
        if ((i > 1 and j > 1 and n and w and not se)
                or (i > 1 and j < W - 1 and n and e and not sw)
                or (i < H - 1 and j < W - 1 and s and e and not nw)
                or (i < H - 1 and j > 1 and s and w and not ne)):
            m[i, j] = False
    return m


# ----------------------------------------------------------------------
# Stage 2: pixel adjacency
# ----------------------------------------------------------------------

def build_pixel_edges(mask: np.ndarray,
                      loop_check_dist: int = 8) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Return (node_xy [N,2] float32, edges [E,2] int64) — EXACT
    reference NoCycles semantics.

    Row-major scan with forward neighbors C1=E, C2=S, C3=SE, C4=SW
    (the SW case only for j > 1, and the last row/column never act as
    P); an edge is added only if the two pixels are NOT already
    connected within `loop_check_dist` hops — a bounded BFS, exactly
    `is_connected(a, b, LOOP_CHECK_DIST=8)`
    (parity: convertEdgeImagePixelToGraph_NoCycles,
    convert_edge_images_pixel_to_segment.cpp:347-426).
    Node coords are pixel centers (col+0.5, row+0.5) (:330).

    Sparse Python loop — behavior-defining fallback; the native path
    (native/extraction.cpp) implements the identical algorithm.
    """
    from collections import deque

    H, Wd = mask.shape
    node_id = np.full((H, Wd), -1, dtype=np.int64)
    ys, xs = np.nonzero(mask)
    node_id[ys, xs] = np.arange(len(ys))
    xy = np.stack([xs + 0.5, ys + 0.5], axis=1).astype(np.float32)

    adj: list = [[] for _ in range(len(ys))]
    edges = []

    def connected_within(a, b, maxhops):
        if maxhops <= 0:
            return a == b
        seen = {a}
        frontier = deque([(a, 0)])
        while frontier:
            u, d = frontier.popleft()
            if d >= maxhops:
                continue
            for v in adj[u]:
                if v == b:
                    return True
                if v not in seen:
                    seen.add(v)
                    frontier.append((v, d + 1))
        return False

    m = mask
    for i, j in zip(ys.tolist(), xs.tolist()):
        if i >= H - 1 or j >= Wd - 1:
            continue
        u = node_id[i, j]
        cand = [(i, j + 1), (i + 1, j), (i + 1, j + 1)]
        if j > 1:
            cand.append((i + 1, j - 1))
        for ci, cj in cand:
            if not m[ci, cj]:
                continue
            v = node_id[ci, cj]
            if u != v and not connected_within(u, v, loop_check_dist):
                adj[u].append(v)
                adj[v].append(u)
                edges.append((u, v))
    edges = (np.asarray(edges, dtype=np.int64) if edges
             else np.zeros((0, 2), dtype=np.int64))
    return xy, edges


# ----------------------------------------------------------------------
# Stage 3: chain tracing by list ranking
# ----------------------------------------------------------------------

def trace_chains(node_xy: np.ndarray, edges: np.ndarray) -> list[np.ndarray]:
    """Extract maximal chains (paths between non-degree-2 nodes, plus
    cycles) as coordinate arrays, via pointer-doubling list ranking over
    directed half-edges."""
    N = len(node_xy)
    Eu = len(edges)
    if Eu == 0:
        return []
    # directed half-edges: [0..Eu) = u->v, [Eu..2Eu) = v->u
    he_u = np.concatenate([edges[:, 0], edges[:, 1]])
    he_v = np.concatenate([edges[:, 1], edges[:, 0]])
    M = 2 * Eu
    rev = np.concatenate([np.arange(Eu) + Eu, np.arange(Eu)])

    deg = np.bincount(he_u, minlength=N)
    # neighbor-id sum per node -> "other neighbor" trick for deg-2 nodes
    nb_sum = np.bincount(he_u, weights=he_v.astype(np.float64),
                         minlength=N).astype(np.int64)

    # successor: he (u->v) continues to (v->w) iff deg(v)==2
    w = nb_sum[he_v] - he_u
    key = he_u * N + he_v
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    succ_key = he_v * N + w
    pos = np.searchsorted(key_sorted, succ_key)
    pos = np.clip(pos, 0, M - 1)
    succ_he = order[pos]
    has_succ = (deg[he_v] == 2) & (key_sorted[np.clip(pos, 0, M - 1)] == succ_key)
    succ = np.where(has_succ, succ_he, np.arange(M))

    # --- break cycles: min-id label propagation then cut before canonical
    nxt = succ.copy()
    steps = max(int(np.ceil(np.log2(max(M, 2)))) + 1, 1)
    for _ in range(steps):
        nxt = nxt[nxt]
    in_cycle = succ[nxt] != nxt          # final target is not a terminator
    if in_cycle.any():
        lab = np.arange(M)
        tn = succ.copy()
        for _ in range(steps):
            lab = np.minimum(lab, lab[tn])
            tn = tn[tn]
        cut = in_cycle & (succ != np.arange(M)) & (lab[succ] == lab) \
            & (succ == lab)              # he whose successor is the canonical start
        succ = np.where(cut, np.arange(M), succ)

    # --- list ranking: distance to chain end + chain end id
    rank = (succ != np.arange(M)).astype(np.int64)
    nxt = succ.copy()
    for _ in range(steps):
        rank = rank + rank[nxt]
        nxt = nxt[nxt]
    chain_end = nxt                       # terminator half-edge per element

    # group by chain, order by rank descending (start has max rank)
    grp = np.lexsort((-rank, chain_end))
    ce_sorted = chain_end[grp]
    boundaries = np.flatnonzero(np.diff(ce_sorted)) + 1
    chains_idx = np.split(grp, boundaries)

    out = []
    for ch in chains_idx:
        start_he = ch[0]
        last_he = ch[-1]
        # dedup: each undirected chain is traced in both directions.
        if deg[he_u[start_he]] == 2:
            # broken pure cycle: keep the direction whose canonical
            # (minimal) half-edge id beats the reverse cycle's minimum
            if start_he > rev[ch].min():
                continue
        elif start_he > rev[last_he]:
            # path / hub loop: reverse trace starts at rev[last_he]
            continue
        nodes = np.concatenate([he_u[ch], [he_v[last_he]]])
        out.append(node_xy[nodes])
    return out


# ----------------------------------------------------------------------
# Stage 4: optimization passes on chain lists
# ----------------------------------------------------------------------

def simplify_polyline(pts: np.ndarray, tol: float) -> np.ndarray:
    """Douglas-Peucker simplification; no retained point deviates more
    than `tol` from the simplified chain (parity:
    PolyLineGraph2D::simplify_polyline, polyline_graph_2d.cpp:968-1013,
    MAXIMUM_LINEARIZABILITY_DISTANCE 1.0)."""
    n = len(pts)
    if n <= 2:
        return pts
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        a, b = stack.pop()
        if b - a < 2:
            continue
        seg = pts[b] - pts[a]
        L2 = seg @ seg
        mid = pts[a + 1:b] - pts[a]
        if L2 < 1e-12:
            d2 = np.sum(mid * mid, axis=1)
        else:
            t = np.clip((mid @ seg) / L2, 0.0, 1.0)
            proj = np.outer(t, seg)
            d2 = np.sum((mid - proj) ** 2, axis=1)
        imax = int(np.argmax(d2))
        if d2[imax] > tol * tol:
            k = a + 1 + imax
            keep[k] = True
            stack.append((a, k))
            stack.append((k, b))
    return pts[keep]


def _endpoint_key(xy: np.ndarray, quant: float = 0.25) -> tuple[int, int]:
    return (int(round(xy[0] / quant)), int(round(xy[1] / quant)))


def _endpoint_counts(chains: list[np.ndarray]) -> dict:
    counts: dict = {}
    for i, ch in enumerate(chains):
        for end, xy in ((0, ch[0]), (1, ch[-1])):
            counts.setdefault(_endpoint_key(xy), []).append((i, end))
    return counts


def merge_degree2_nodes(chains: list[np.ndarray]) -> list[np.ndarray]:
    """Merge polylines across pure 2-connection nodes (parity:
    remove_2connection_nodes, polyline_graph_2d_hmap_impl.cpp:175-201).

    Single-pass stitching: chains are edges in a multigraph over endpoint
    keys; nodes with exactly two incidences are pass-throughs, so walk
    maximal chain sequences once (O(total))."""
    chains = [np.asarray(c) for c in chains]
    counts = _endpoint_counts(chains)
    # next[(i, end)] -> (j, end') across a 2-incidence node
    link: dict = {}
    for incid in counts.values():
        if len(incid) == 2 and incid[0][0] != incid[1][0]:
            a, b = incid
            link[a] = b
            link[b] = a

    visited = [False] * len(chains)
    out = []
    for i in range(len(chains)):
        if visited[i]:
            continue
        # find a free end to start from (not linked), else cycle start
        start = None
        for end in (0, 1):
            if (i, end) not in link:
                start = (i, 1 - end)   # walk away from the free end
                break
        if start is None:
            start = (i, 1)             # chain-cycle: arbitrary orientation
        parts = []
        cur_chain, cur_out_end = start
        while True:
            visited[cur_chain] = True
            c = chains[cur_chain]
            parts.append(c if cur_out_end == 1 else c[::-1])
            nxt = link.get((cur_chain, cur_out_end))
            if nxt is None or visited[nxt[0]]:
                break
            cur_chain, cur_out_end = nxt[0], 1 - nxt[1]
        merged = parts[0] if len(parts) == 1 else np.concatenate(
            [parts[0]] + [p[1:] for p in parts[1:]], axis=0)
        out.append(merged)
    return out


def _components_of_chains(chains: list[np.ndarray]) -> np.ndarray:
    parent = list(range(len(chains)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    counts = _endpoint_counts(chains)
    for incid in counts.values():
        base = incid[0][0]
        for i, _ in incid[1:]:
            ra, rb = find(base), find(i)
            if ra != rb:
                parent[rb] = ra
    return np.asarray([find(i) for i in range(len(chains))])


def _cross2(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _segments_cross(p1, p2, q1, q2) -> bool:
    d1 = _cross2(p2 - p1, q1 - p1)
    d2 = _cross2(p2 - p1, q2 - p1)
    d3 = _cross2(q2 - q1, p1 - q1)
    d4 = _cross2(q2 - q1, p2 - q1)
    return ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0))


def connect_close_extremes(chains: list[np.ndarray], max_dist: float,
                           ) -> list[np.ndarray]:
    """Bridge extremes of different components within `max_dist`, unless
    the bridge crosses an existing segment (parity:
    connect_close_extremes, polyline_graph_2d_hmap_impl.cpp:141-168)."""
    if not chains:
        return chains
    comp = _components_of_chains(chains)
    counts = _endpoint_counts(chains)
    extremes = []  # (xy, chain, comp)
    for key, incid in counts.items():
        if len(incid) == 1:
            i, end = incid[0]
            xy = chains[i][0] if end == 0 else chains[i][-1]
            extremes.append((xy, i, comp[i]))
    if len(extremes) < 2:
        return chains
    ex_xy = np.asarray([e[0] for e in extremes])
    ex_comp = np.asarray([e[2] for e in extremes])

    # spatial hash of extremes (cell = max_dist) -> candidate pairs from
    # 3x3 neighborhoods; avoids the O(n^2) distance matrix
    cell = max(max_dist, 1e-6)
    keys = np.floor(ex_xy / cell).astype(np.int64)
    buckets: dict = {}
    for i, k in enumerate(map(tuple, keys)):
        buckets.setdefault(k, []).append(i)
    cand = []
    for (kx, ky), idxs in buckets.items():
        neigh = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                neigh.extend(buckets.get((kx + dx, ky + dy), []))
        for a in idxs:
            for b in neigh:
                if a < b and ex_comp[a] != ex_comp[b]:
                    d2 = float(np.sum((ex_xy[a] - ex_xy[b]) ** 2))
                    if d2 <= max_dist * max_dist:
                        cand.append((d2, a, b))
    cand.sort()

    # spatial hash of existing segments for the crossing test
    seg_buckets: dict = {}
    all_segs = []
    for c in chains:
        for k in range(len(c) - 1):
            sid = len(all_segs)
            all_segs.append((c[k], c[k + 1]))
            lo = np.floor(np.minimum(c[k], c[k + 1]) / cell).astype(np.int64)
            hi = np.floor(np.maximum(c[k], c[k + 1]) / cell).astype(np.int64)
            for gx in range(lo[0], hi[0] + 1):
                for gy in range(lo[1], hi[1] + 1):
                    seg_buckets.setdefault((gx, gy), []).append(sid)

    bridged = []
    merged_comp = {int(c): int(c) for c in np.unique(ex_comp)}

    def root(c):
        while merged_comp[c] != c:
            c = merged_comp[c]
        return c

    for d2, a, b in cand:
        ca, cb = root(int(ex_comp[a])), root(int(ex_comp[b]))
        if ca == cb:
            continue
        p1, p2 = ex_xy[a], ex_xy[b]
        lo = np.floor(np.minimum(p1, p2) / cell).astype(np.int64)
        hi = np.floor(np.maximum(p1, p2) / cell).astype(np.int64)
        near = set()
        for gx in range(lo[0] - 1, hi[0] + 2):
            for gy in range(lo[1] - 1, hi[1] + 2):
                near.update(seg_buckets.get((gx, gy), ()))
        crossing = any(_segments_cross(p1, p2, all_segs[s][0], all_segs[s][1])
                       for s in near)
        if crossing:
            continue
        bridged.append(np.stack([p1, p2]).astype(np.float32))
        merged_comp[max(ca, cb)] = min(ca, cb)
    return chains + bridged


def _extreme_direction(chain: np.ndarray, end: int,
                       probe_len: float = 5.0) -> np.ndarray | None:
    """Outward direction at a chain extreme, measured over >= probe_len
    of arc (parity: get_extreme_direction_length_given_length,
    polyline_graph_2d.cpp:198-240, PROLONG_EXTREME_MIN_SEGMENT_LENGTH 5).
    Returns None when the whole chain is shorter than probe_len
    (the reference skips such extremes, hmap_impl.cpp:287-289)."""
    pts = chain if end == 1 else chain[::-1]
    init = pts[-1]
    residual_sq = probe_len * probe_len
    final = None
    for i in range(len(pts) - 2, -1, -1):
        seg = pts[i] - pts[i + 1]
        ls = float(seg @ seg)
        if residual_sq <= ls:
            ratio = residual_sq / max(ls, 1e-12)
            final = pts[i + 1] + ratio * seg
            residual_sq = 0.0
            break
        residual_sq -= ls
    if final is None:
        return None
    d = init - final
    n = float(np.linalg.norm(d))
    return d / n if n > 1e-9 else None


def connect_close_extremes_following_direction(
        chains: list[np.ndarray], max_dist: float = 15.0,
        min_cos: float = 0.707) -> list[np.ndarray]:
    """Bridge mutually-closest extreme pairs of different components
    whose connecting segment aligns with BOTH extremes' outward
    directions (|cos| >= min_cos) and crosses no existing polyline
    (parity: connect_close_extremes_following_direction,
    polyline_graph_2d_hmap_impl.cpp:323-350 +
    find_closest_pairs_with_max_dist_following_direction,
    polyline_graph_2d.cpp:1357-1400; constants
    DIRECT_CONNECTION_EXTREMES_FOLLOWING_DIRECTION_MAXDIST 15 /
    MINCOS 0.707).  Library surface like the reference's: the
    production optimize() does not call it."""
    if not chains:
        return chains
    comp = _components_of_chains(chains)
    counts = _endpoint_counts(chains)
    ex = []   # (xy, dir, comp)
    for key, incid in counts.items():
        if len(incid) != 1:
            continue
        i, end = incid[0]
        d = _extreme_direction(chains[i], end)
        if d is None:
            continue
        xy = chains[i][0] if end == 0 else chains[i][-1]
        ex.append((xy, d, comp[i]))
    n = len(ex)
    if n < 2:
        return chains
    xy = np.asarray([e[0] for e in ex])
    dirs = np.asarray([e[1] for e in ex])
    comps = np.asarray([e[2] for e in ex])
    # mutual-closest pairs under the direction constraint
    diff = xy[None, :] - xy[:, None]                 # [n,n,2] j - i
    dist_sq = np.sum(diff ** 2, axis=-1)
    np.fill_diagonal(dist_sq, np.inf)
    dn = np.maximum(np.sqrt(dist_sq), 1e-12)
    cos_i = np.abs(np.sum(diff * dirs[:, None], axis=-1)) / dn
    cos_j = np.abs(np.sum(diff * dirs[None, :], axis=-1)) / dn
    ok = (dist_sq <= max_dist ** 2) & (cos_i >= min_cos) & \
        (cos_j >= min_cos)
    d_ok = np.where(ok, dist_sq, np.inf)
    closest = np.argmin(d_ok, axis=1)
    out = list(chains)
    merged = {int(c): int(c) for c in np.unique(comps)}

    def root(c):
        while merged[c] != c:
            c = merged[c]
        return c

    for i in range(n):
        j = int(closest[i])
        if j < i and closest[j] == i and np.isfinite(d_ok[i, j]):
            ca, cb = root(int(comps[i])), root(int(comps[j]))
            if ca == cb:
                continue
            p1, p2 = xy[i], xy[j]
            crossing = any(
                _segments_cross(p1, p2, c[k], c[k + 1])
                for c in chains for k in range(len(c) - 1))
            if crossing:
                continue
            out.append(np.stack([p1, p2]).astype(np.float32))
            merged[max(ca, cb)] = min(ca, cb)
    return out


def prolong_extremes_and_intersect(chains: list[np.ndarray],
                                   max_dist: float,
                                   probe_len: float = 5.0
                                   ) -> list[np.ndarray]:
    """Prolong every extreme along its outward direction; if the ray
    hits another polyline within `max_dist`, split the hit polyline
    there and bridge (parity: prolong_extremes_and_intersect,
    polyline_graph_2d_hmap_impl.cpp:282-321).  Library surface like the
    reference's: the production optimize() does not call it."""
    out = [np.asarray(c) for c in chains]
    counts = _endpoint_counts(out)
    extremes = [(i, end) for incid in counts.values() if len(incid) == 1
                for (i, end) in incid]
    for i, end in extremes:
        c = out[i]
        d = _extreme_direction(c, end, probe_len)
        if d is None:
            continue
        origin = c[0] if end == 0 else c[-1]
        best = None   # (dist, chain_idx, seg_idx, point)
        for j, cj in enumerate(out):
            if j == i:
                continue
            a = cj[:-1]
            b = cj[1:]
            # ray x segment intersection
            u = b - a
            denom = d[0] * (-u[:, 1]) + d[1] * u[:, 0]
            ok = np.abs(denom) > 1e-12
            rel = a - origin
            tt = (rel[:, 0] * (-u[:, 1]) + rel[:, 1] * u[:, 0]) \
                / np.where(ok, denom, 1.0)
            ss = (d[0] * rel[:, 1] - d[1] * rel[:, 0]) \
                / np.where(ok, denom, 1.0)
            hit = ok & (tt > 1e-6) & (tt <= max_dist) & (ss >= 0.0) \
                & (ss <= 1.0)
            if hit.any():
                k = int(np.argmin(np.where(hit, tt, np.inf)))
                if best is None or tt[k] < best[0]:
                    best = (float(tt[k]), j, k, a[k] + ss[k] * u[k])
        if best is not None:
            _, j, k, pt = best
            cj = out[j]
            left = np.concatenate([cj[: k + 1], pt[None]], axis=0)
            right = np.concatenate([pt[None], cj[k + 1:]], axis=0)
            out[j] = left.astype(np.float32)
            out.append(right.astype(np.float32))
            out.append(np.stack([origin, pt]).astype(np.float32))
    return out


def optimize_chains(chains: list[np.ndarray],
                    config: EdgeGraphConfig) -> list[np.ndarray]:
    """Full optimize() pass order (parity:
    PolyLineGraph2DHMapImpl::optimize, polyline_graph_2d_hmap_impl.cpp:255-266)."""
    # remove invalid + degenerate loops (< degenerate_loop_min_coords)
    out = []
    for c in chains:
        if len(c) < 2:
            continue
        is_loop = np.allclose(c[0], c[-1])
        if is_loop and len(c) < config.degenerate_loop_min_coords:
            continue
        out.append(c)
    out = merge_degree2_nodes(out)
    out = [simplify_polyline(c, config.simplify_tolerance_px) for c in out]
    out = connect_close_extremes(out, config.connect_extremes_max_dist_px)
    # split long loops (parity: split_loops, hmap_impl.cpp:237-253)
    split = []
    for c in out:
        if len(c) >= config.split_loop_min_len and np.allclose(c[0], c[-1]):
            mid = len(c) // 2
            split.append(c[: mid + 1])
            split.append(c[mid:])
        else:
            split.append(c)
    return split


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------

def extract_chains_native(mask: np.ndarray,
                          config: EdgeGraphConfig) -> list[np.ndarray] | None:
    """C++ fast path for stages 1-4 (edgegraph3d_tpu/native/extraction.cpp);
    returns None when the native library is unavailable."""
    import ctypes

    from edgegraph3d_tpu_torch.native import get_extraction_lib
    lib = get_extraction_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask.astype(np.uint8))
    H, W = m.shape
    max_coords = int(m.sum()) * 2 + 16
    max_chains = max_coords // 2 + 4
    coords = np.empty((max_coords, 2), dtype=np.float32)
    offsets = np.empty(max_chains + 1, dtype=np.int64)
    n_chains = ctypes.c_int64(0)
    n_coords = ctypes.c_int64(0)
    rc = lib.eg3d_extract_chains(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        ctypes.c_float(config.simplify_tolerance_px),
        ctypes.c_float(config.connect_extremes_max_dist_px),
        config.degenerate_loop_min_coords, config.split_loop_min_len,
        config.loop_check_dist,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_coords,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_chains, ctypes.byref(n_chains), ctypes.byref(n_coords))
    if rc != 0:
        return None
    nc = n_chains.value
    return [coords[offsets[i]:offsets[i + 1]].copy() for i in range(nc)]


def extract_plg(edge_image: np.ndarray,
                config: EdgeGraphConfig = DEFAULT_CONFIG,
                optimize: bool = True, use_native: bool = True) -> PLG2D:
    """Edge image (uint8 {0,255} or bool, [H,W]) -> optimized PLG2D
    (parity: convertEdgeImagePolyLineGraph_optimized,
    convert_edge_images_pixel_to_segment.cpp:868-892).

    The C++ fast path (native/extraction.cpp) is used when available;
    the numpy implementation below defines the behavior and remains the
    fallback."""
    mask = edge_image > 0 if edge_image.dtype != bool else edge_image
    chains = None
    if optimize and use_native:
        chains = extract_chains_native(mask, config)
    if chains is None:
        mask = remove_useless_corners(mask)
        node_xy, edges = build_pixel_edges(
            mask, loop_check_dist=config.loop_check_dist)
        chains = trace_chains(node_xy, edges)
        if optimize:
            chains = optimize_chains(chains, config)
    plg = from_polyline_list(chains,
                             max_polylines=config.max_polylines_per_view,
                             max_len=config.max_polyline_len)
    if optimize:
        plg = plg.filter_components_by_smooth_length(
            config.top_smooth_length_keep, config.smooth_cos_min)
    return plg


def extract_plgs(edge_images: np.ndarray,
                 config: EdgeGraphConfig = DEFAULT_CONFIG,
                 optimize: bool = True) -> PLGStack:
    """[V,H,W] edge images -> stacked PLGs (parity:
    convert_edge_images_to_optimized_polyline_graphs,
    convert_edge_images_pixel_to_segment.cpp:885-892).

    Views are extracted in parallel host threads (the native path
    releases the GIL around the C++ call) — the equivalent of the
    reference's OpenMP loop over images."""
    from concurrent.futures import ThreadPoolExecutor
    V = edge_images.shape[0]
    with ThreadPoolExecutor(max_workers=min(V, os.cpu_count() or 1)) as ex:
        plgs = list(ex.map(
            lambda v: extract_plg(edge_images[v], config, optimize),
            range(V)))
    return stack_plgs(plgs, config.max_polylines_per_view,
                      config.max_polyline_len)
