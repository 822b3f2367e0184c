"""Community detection for the stage-1 similarity graph.

Port of edgegraph3d_tpu/matching/communities.py.  Label propagation (LP)
runs in torch on the graph's device; modularity, the two Louvain passes,
the LP-then-merge refinement and the method dispatch are the JAX
package's host (numpy) code, copied.

LP is synchronous weighted label propagation with ties toward the smaller
label and an early exit once a round changes no label.  Every round sums
each (receiver, label) bucket of directed contributions in update order
(all edges forward, then all edges backward), as JAX's scatter-add does
on the CPU: a stable sort by (receiver, label) key, then
`torch.segment_reduce` over a [E, 1] column, whose CPU and CUDA kernels
add each segment's values one after another from 0.  No float atomics:
weights are Jaccard fractions and often equal, and an unordered sum
could split equal scores and flip a label.  Each receiver then takes the
largest bucket, ties toward the smaller label (scatter-max, then
scatter-min): the JAX package's sparse form.  Its dense [n, n] scoreboard
(taken at or below 16,384 padded nodes) computes the same sums with the
same tie rule, so one form serves every size here.
"""

from __future__ import annotations

import numpy as np
import torch

from edgegraph3d_tpu_torch.devices import resolve_device


def _directed(edges: torch.Tensor, weights: torch.Tensor):
    """Both directions of every edge, forward first: (src, dst, w) of
    length 2E."""
    w = weights.to(torch.float32)
    src = torch.cat([edges[:, 0], edges[:, 1]]).long()
    dst = torch.cat([edges[:, 1], edges[:, 0]]).long()
    return src, dst, torch.cat([w, w])


def _bucket_sums(src, dst, ww, labels, n: int):
    """(receiver, label, score) per non-empty bucket, each score summed
    in update order."""
    key = src * n + labels[dst]
    key_s, order = torch.sort(key, stable=True)
    start = torch.ones_like(key_s, dtype=torch.bool)
    start[1:] = key_s[1:] != key_s[:-1]
    first = torch.nonzero(start).flatten()
    lengths = torch.diff(first, append=first.new_tensor([len(key_s)]))
    sums = torch.segment_reduce(ww[order][:, None], "sum", lengths=lengths,
                                axis=0)[:, 0]
    gk = key_s[first]
    return gk // n, gk % n, sums


def _step(src, dst, ww, labels, n: int):
    g_src, g_lab, sums = _bucket_sums(src, dst, ww, labels, n)
    best = torch.full((n,), -1.0, dtype=torch.float32,
                      device=labels.device).scatter_reduce(
        0, g_src, sums, "amax")
    # JAX's 1e-12 slack: below half an f32 ULP for sums above 2e-5, so
    # it ties only equal sums, as the dense scoreboard's argmax does
    is_best = (sums >= best[g_src] - 1e-12) & (sums > 0)
    new = torch.full((n,), n, dtype=labels.dtype,
                     device=labels.device).scatter_reduce(
        0, g_src[is_best], g_lab[is_best], "amin")
    return torch.where((best > 0) & (new < n), new, labels)


def label_propagation(edges: torch.Tensor, weights: torch.Tensor,
                      n_nodes: int, n_iters: int = 30) -> torch.Tensor:
    """edges [E, 2] (undirected), weights [E] -> labels
    [n_nodes] (int64, on the edges' device); stops after the first round
    that changes no label."""
    src, dst, ww = _directed(edges, weights)
    labels = torch.arange(n_nodes, device=edges.device)
    for _ in range(n_iters):
        new = _step(src, dst, ww, labels, n_nodes)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


# ----------------------------------------------------------------------
# Host code, copied from the JAX package
# ----------------------------------------------------------------------

def modularity(edges: np.ndarray, weights: np.ndarray,
               labels: np.ndarray) -> float:
    """Weighted Newman modularity Q of a partition (host-side scorer).

    Q = (1/2m) sum_ij (A_ij - k_i k_j / 2m) delta(c_i, c_j).  Self-loops
    count once in the sum over ij (and once in 2m / k_i), a non-self edge
    twice."""
    edges = np.asarray(edges)
    weights = np.asarray(weights, np.float64)
    labels = np.asarray(labels)
    if len(edges) == 0:
        return 0.0
    ok = (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    e, w = edges[ok], weights[ok]
    sl = e[:, 0] == e[:, 1]
    w_self = w[sl].sum()
    two_m = 2.0 * w[~sl].sum() + w_self
    if two_m <= 0:
        return 0.0
    deg = np.zeros(labels.shape[0])
    np.add.at(deg, e[~sl, 0], w[~sl])
    np.add.at(deg, e[~sl, 1], w[~sl])
    np.add.at(deg, e[sl, 0], w[sl])
    same = (labels[e[:, 0]] == labels[e[:, 1]]) & ~sl
    w_in = 2.0 * w[same].sum() + w_self       # intra weight, Newman count
    n_comm = labels.max() + 1
    sum_tot = np.zeros(int(n_comm) + 1)
    np.add.at(sum_tot, labels, deg)
    return float(w_in / two_m - np.sum((sum_tot / two_m) ** 2))


def _louvain_one_level(indptr: np.ndarray, nbr: np.ndarray,
                       w: np.ndarray, deg: np.ndarray,
                       two_m: float) -> np.ndarray:
    """One sequential local-moving pass over a CSR adjacency: greedily
    move nodes to the neighbouring community with the best modularity
    gain until no move improves (active-queue scheduling, ties toward
    the smaller community label)."""
    n = len(deg)
    labels = np.arange(n)
    sum_tot = deg.copy()                       # per-community degree
    active = np.ones(n, dtype=bool)
    for _ in range(64):
        idx = np.flatnonzero(active)
        if len(idx) == 0:
            break
        active[:] = False
        moved = False
        for i in idx:
            s, t = indptr[i], indptr[i + 1]
            if s == t:
                continue
            ln = labels[nbr[s:t]]
            o = np.argsort(ln, kind="stable")
            lx, wx = ln[o], w[s:t][o]
            starts = np.flatnonzero(
                np.concatenate(([True], lx[1:] != lx[:-1])))
            comms = lx[starts]                 # ascending
            wc = np.add.reduceat(wx, starts)
            ci = labels[i]
            sum_tot[ci] -= deg[i]
            gains = wc - deg[i] * sum_tot[comms] / two_m
            p = np.searchsorted(comms, ci)
            stay = (gains[p] if p < len(comms) and comms[p] == ci
                    else -deg[i] * sum_tot[ci] / two_m)
            j = int(np.argmax(gains))          # first max = smallest c
            best_c, best_g = int(comms[j]), float(gains[j])
            move = (best_g > stay + 1e-12
                    or (abs(best_g - stay) <= 1e-12 and best_c < ci))
            new_c = best_c if move else ci
            labels[i] = new_c
            sum_tot[new_c] += deg[i]
            if new_c != ci:
                moved = True
                active[nbr[s:t]] = True
        if not moved:
            break
    return labels


def _louvain_one_level_parallel(indptr: np.ndarray, nbr: np.ndarray,
                                w: np.ndarray, deg: np.ndarray,
                                two_m: float, n_batches: int = 16,
                                max_sweeps: int = 24) -> np.ndarray:
    """Batch-parallel local moving: nodes in deterministic batches; within
    a batch every node evaluates its best move against the labels at
    batch start and all moves apply together.  Same move rule as the
    sequential pass."""
    n = len(deg)
    labels = np.arange(n)
    sum_tot = deg.copy()
    rng = np.random.default_rng(0)
    batch_of = rng.integers(0, n_batches, n)          # deterministic
    active = np.ones(n, dtype=bool)
    for _ in range(max_sweeps):
        if not active.any():
            break
        moved_any = False
        for b in range(n_batches):
            sel = active & (batch_of == b)
            idx = np.flatnonzero(sel)
            if len(idx) == 0:
                continue
            # flat adjacency rows of the batch
            rs = indptr[idx]
            re = indptr[idx + 1]
            ln = re - rs
            F = int(ln.sum())
            if F == 0:
                active[idx] = False
                continue
            node_of = np.repeat(np.arange(len(idx)), ln)
            flat = _flat_ranges(rs, re, F)
            lab_n = labels[nbr[flat]]
            wv = w[flat]
            # group by (batch-node, neighbour label)
            key = node_of.astype(np.int64) * n + lab_n
            uk, inv = np.unique(key, return_inverse=True)
            wc = np.bincount(inv, weights=wv)
            g_node = (uk // n).astype(np.int64)
            g_lab = (uk % n).astype(np.int64)
            gi = idx[g_node]
            ci = labels[gi]
            st_adj = sum_tot[g_lab] - deg[gi] * (g_lab == ci)
            gains = wc - deg[gi] * st_adj / two_m
            # stay gain per batch node (0 when ci absent from nbrs)
            stay = -deg[idx] * (sum_tot[ci_b := labels[idx]]
                                - deg[idx]) / two_m
            own = g_lab == ci
            stay_present = np.zeros(len(idx))
            stay_present[g_node[own]] = gains[own]
            has_own = np.zeros(len(idx), dtype=bool)
            has_own[g_node[own]] = True
            stay = np.where(has_own, stay_present, stay)
            # best move per batch node: max gain, ties -> smaller label
            order = np.lexsort((g_lab, -gains, g_node))
            first = np.concatenate(
                [[True], g_node[order][1:] != g_node[order][:-1]])
            top = order[first]
            bn = g_node[top]
            best_c = g_lab[top]
            best_g = gains[top]
            mv = (best_g > stay[bn] + 1e-12) \
                | ((np.abs(best_g - stay[bn]) <= 1e-12)
                   & (best_c < ci_b[bn]))
            mv &= best_c != ci_b[bn]
            movers = idx[bn[mv]]
            if len(movers):
                moved_any = True
                newc = best_c[mv]
                np.subtract.at(sum_tot, labels[movers], deg[movers])
                np.add.at(sum_tot, newc, deg[movers])
                labels[movers] = newc
                # wake the movers' neighbours
                ms, me = indptr[movers], indptr[movers + 1]
                wake = _flat_ranges(ms, me, int((me - ms).sum()))
                active[nbr[wake]] = True
            active[idx] = False
        if not moved_any:
            break
    return labels


def _flat_ranges(starts: np.ndarray, ends: np.ndarray,
                 total: int) -> np.ndarray:
    """Concatenate integer ranges [starts[i], ends[i]) — vectorized."""
    ln = ends - starts
    out = np.repeat(starts, ln)
    off = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(ln)[:-1]]), ln)
    return out + off


def louvain_host(edges: np.ndarray, weights: np.ndarray,
                 n_nodes: int, max_phases: int = 10,
                 parallel: bool | None = None) -> np.ndarray:
    """Multi-phase Louvain on the host: local moving to a modularity
    local optimum, aggregate communities into super-nodes, repeat until
    no phase merges anything.  `parallel` picks the local-moving pass:
    False = sequential, True = batch-parallel, None = sequential up to
    LOUVAIN_MAX_NODES nodes."""
    edges = np.asarray(edges)
    weights = np.asarray(weights, np.float64)
    ok = (edges[:, 0] >= 0) & (edges[:, 1] >= 0) \
        if len(edges) else np.zeros(0, bool)
    e, w = edges[ok].astype(np.int64), weights[ok]
    if parallel is None:
        parallel = n_nodes > LOUVAIN_MAX_NODES
    total_map = np.arange(n_nodes)
    n = n_nodes
    self_w = np.zeros(n)
    for _ in range(max_phases):
        two_m = 2.0 * w.sum() + self_w.sum()
        if two_m <= 0:
            break
        deg = self_w.copy()
        np.add.at(deg, e[:, 0], w)
        np.add.at(deg, e[:, 1], w)
        # CSR adjacency (self-loops excluded; they live in deg/self_w)
        ns = e[:, 0] != e[:, 1]
        src = np.concatenate([e[ns, 0], e[ns, 1]])
        dst = np.concatenate([e[ns, 1], e[ns, 0]])
        ww2 = np.concatenate([w[ns], w[ns]])
        order = np.argsort(src, kind="stable")
        indptr = np.searchsorted(src[order], np.arange(n + 1))
        level = _louvain_one_level_parallel if parallel \
            else _louvain_one_level
        lab = level(indptr, dst[order], ww2[order], deg, two_m)
        uniq, lab_c = np.unique(lab, return_inverse=True)
        total_map = lab_c[total_map]
        if len(uniq) == n:
            break
        # aggregate: communities become super-nodes
        n2 = len(uniq)
        self2 = np.zeros(n2)
        np.add.at(self2, lab_c, self_w)
        ec = lab_c[e]
        lo = np.minimum(ec[:, 0], ec[:, 1])
        hi = np.maximum(ec[:, 0], ec[:, 1])
        self_m = lo == hi
        np.add.at(self2, lo[self_m], 2.0 * w[self_m])
        key = lo[~self_m] * n2 + hi[~self_m]
        uk, inv = np.unique(key, return_inverse=True)
        ws = np.zeros(len(uk))
        np.add.at(ws, inv, w[~self_m])
        e = np.stack([uk // n2, uk % n2], axis=1)
        w = ws
        self_w = self2
        n = n2
    return total_map


def refine_labels_by_modularity(edges: np.ndarray, weights: np.ndarray,
                                labels: np.ndarray) -> np.ndarray:
    """LP-then-merge: aggregate the LP communities into super-nodes and
    run host Louvain on the community graph (merges over-split
    communities; cannot split)."""
    edges = np.asarray(edges)
    weights = np.asarray(weights, np.float64)
    ok = (edges[:, 0] >= 0) & (edges[:, 1] >= 0) \
        if len(edges) else np.zeros(0, bool)
    e, w = edges[ok], weights[ok]
    uniq, lab_c = np.unique(labels, return_inverse=True)
    n_c = len(uniq)
    if n_c <= 1 or len(e) == 0:
        return np.asarray(labels)
    ec = lab_c[e]
    lo = np.minimum(ec[:, 0], ec[:, 1]).astype(np.int64)
    hi = np.maximum(ec[:, 0], ec[:, 1]).astype(np.int64)
    key = lo * n_c + hi
    uk, inv = np.unique(key, return_inverse=True)
    w2 = np.zeros(len(uk))
    np.add.at(w2, inv, w)
    e2 = np.stack([uk // n_c, uk % n_c], axis=1)
    merged = louvain_host(e2, w2, n_c)
    return merged[lab_c]


#: graphs at or below this node count take the sequential local-moving
#: pass in louvain_host; above it the batch-parallel one
LOUVAIN_MAX_NODES = 20_000


def communities_from_edges(edges: np.ndarray, weights: np.ndarray,
                           n_nodes: int, n_iters: int = 30,
                           min_size: int = 2, method: str = "auto",
                           device="cuda") -> list[np.ndarray]:
    """Edge list -> list of node-id arrays (communities of >= min_size).

    Methods (as in the JAX package): "louvain" (host Louvain), "lp"
    (label propagation on `device`), "lp+merge" (LP, then a host
    modularity merge), "union" (the lp+merge and Louvain communities,
    deduplicated), "union3" (union plus the raw-LP communities) and
    "auto" (= union3).  `device` defaults to "cuda" and raises without a
    GPU, whatever the method."""
    device = resolve_device(device)
    if len(edges) == 0 or n_nodes == 0:
        return []
    if method == "auto":
        method = "union3"

    def run_lp():
        # the JAX package pads the node count to a power of two for its
        # compile cache; padded nodes are isolated and change no label
        lab = label_propagation(
            torch.as_tensor(np.asarray(edges, np.int64), device=device),
            torch.as_tensor(np.asarray(weights, np.float32), device=device),
            n_nodes, n_iters)
        return lab.cpu().numpy()

    def to_comms(labels):
        out = []
        for lab in np.unique(labels):
            members = np.flatnonzero(labels == lab)
            if len(members) >= min_size:
                out.append(members)
        return out

    if method in ("union", "union3"):
        # one LP run feeds both the lp+merge arm and (union3) the
        # raw-LP arm
        lp_labels = run_lp()
        a = to_comms(refine_labels_by_modularity(edges, weights,
                                                 lp_labels))
        b = to_comms(louvain_host(edges, weights, n_nodes))
        if method == "union3":
            b = b + to_comms(lp_labels)
        seen = {frozenset(int(x) for x in c) for c in a}
        out3 = list(a)
        for c in b:
            key = frozenset(int(x) for x in c)
            if key not in seen:
                seen.add(key)
                out3.append(c)
        return out3
    if method == "louvain":
        labels = louvain_host(edges, weights, n_nodes)
    else:
        labels = run_lp()
        if method == "lp+merge":
            labels = refine_labels_by_modularity(edges, weights, labels)
    return to_comms(labels)
