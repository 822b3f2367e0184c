"""Community detection of the port against the JAX package: the same
communities, in the same order, for every method, on planted-partition
graphs with Jaccard-like weights, with all-equal weights (where label
propagation's tie rule decides), and just above JAX's
LP_DENSE_MAX_NODES (where JAX switches from its dense scoreboard to its
sparse form; the port has the sparse form only).  Exact equality: the
port sums each (receiver, label) bucket in the same order as JAX's CPU
scatter-add, so equal scores stay equal on both sides.

Host Louvain's sequential local-moving pass is native C++ in the port
(native/louvain.cpp): its labels are held to the JAX package's numpy
pass exactly, phase by phase, on the graphs above, on one whose nodes
have more than 128 neighbours in one community (numpy's pairwise sum
splits there) and on one of 4,000 nodes and over 500,000 edges; its
per-community sum is held to np.add.reduceat."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.matching import communities as jc
from edgegraph3d_tpu_torch import native
from edgegraph3d_tpu_torch.matching import communities as tc
from edgegraph3d_tpu_torch.pipeline import PipelineStats


def _planted(n_comm, size, p_out, equal, seed):
    """Cliques of `size` nodes (some intra edges dropped) with sparse
    lighter edges between communities."""
    rng = np.random.default_rng(seed)
    edges, weights = [], []
    jac = np.array([0.25, 1 / 3, 0.5, 2 / 3, 0.75], np.float32)
    n = n_comm * size
    for c in range(n_comm):
        base = c * size
        for i in range(size):
            for j in range(i + 1, size):
                if rng.random() < 0.85:
                    edges.append((base + i, base + j))
                    weights.append(0.5 if equal else rng.choice(jac))
    n_out = int(p_out * n)
    a = rng.integers(0, n, n_out)
    b = rng.integers(0, n, n_out)
    keep = (a // size) != (b // size)
    for x, y in zip(a[keep], b[keep]):
        edges.append((min(x, y), max(x, y)))
        weights.append(0.5 if equal else rng.choice(jac[:2]) * 0.5)
    return (np.asarray(edges, np.int32), np.asarray(weights, np.float32),
            n)


def _planted_large(n_comm, size, p_in, n_out, seed):
    """Vectorised planted partition with Jaccard weights k / m (k <= m
    <= 40, rounded to float32): each intra pair kept with p_in, n_out
    random pairs across communities; undirected, no duplicates."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(size, 1)
    keep = rng.random((n_comm, len(i))) < p_in
    base = (np.arange(n_comm) * size)[:, None]
    a = (base + i)[keep]
    b = (base + j)[keep]
    n = n_comm * size
    x, y = rng.integers(0, n, (2, n_out))
    cross = (x // size) != (y // size)
    a = np.concatenate([a, np.minimum(x, y)[cross]])
    b = np.concatenate([b, np.maximum(x, y)[cross]])
    e = np.unique(np.stack([a, b], axis=1), axis=0)
    m = rng.integers(1, 41, len(e))
    k = rng.integers(1, 41, len(e)) % m + 1
    return e.astype(np.int32), (k / m).astype(np.float32), n


GRAPHS = {
    "jaccard": lambda: _planted(12, 9, 0.6, False, 0),
    "equal": lambda: _planted(12, 9, 0.6, True, 1),
    "above_dense": lambda: _planted(2050, 8, 0.5, False, 2),
    # 2 communities of 300 nodes: ~255 neighbours each in its own
    "wide": lambda: _planted(2, 300, 0.3, False, 3),
    # 4,000 nodes, ~560,000 edges: the dtu49 graph's degree, scaled down
    "large": lambda: _planted_large(20, 200, 0.85, 250_000, 4),
}
CASES = [(g, m) for g in ("jaccard", "equal")
         for m in ("lp", "lp+merge", "louvain", "union", "union3")]
CASES += [("above_dense", "lp"), ("above_dense", "lp+merge")]


@pytest.mark.parametrize("graph,method", CASES)
def test_communities_match_jax(graph, method):
    edges, weights, n = GRAPHS[graph]()
    if graph == "above_dense":
        assert n > jc.LP_DENSE_MAX_NODES
    j = jc.communities_from_edges(edges, weights, n, min_size=3,
                                  method=method)
    t = tc.communities_from_edges(edges, weights, n, min_size=3,
                                  method=method, device="cpu")
    assert len(j) > 2
    assert [c.tolist() for c in t] == [c.tolist() for c in j]


@pytest.mark.parametrize("graph", ["jaccard", "equal", "above_dense"])
def test_label_propagation_matches_jax(graph):
    """The port's one LP form gives JAX's labels, node for node, whether
    JAX takes its dense scoreboard (the two small graphs, padded to a
    power of two as JAX pads them) or its sparse form (above_dense)."""
    edges, weights, n = GRAPHS[graph]()
    n_pad = 1 << int(np.ceil(np.log2(n)))
    j = np.asarray(jc.label_propagation(jnp.asarray(edges),
                                        jnp.asarray(weights), n_pad))[:n]
    t = tc.label_propagation(torch.as_tensor(edges.astype(np.int64)),
                             torch.as_tensor(weights), n).numpy()
    np.testing.assert_array_equal(t, j)
    assert len(np.unique(t)) > 2


def test_modularity_matches_jax():
    edges, weights, n = GRAPHS["jaccard"]()
    labels = jc.louvain_host(edges, weights, n)
    for lab in (labels, np.arange(n) // 9, np.zeros(n, np.int64)):
        assert tc.modularity(edges, weights, lab) == \
            jc.modularity(edges, weights, lab)


def test_empty_graph():
    assert tc.communities_from_edges(np.zeros((0, 2), np.int32),
                                     np.zeros(0), 0, device="cpu") == []


# ----------------------------------------------------------------------
# Host Louvain's native local-moving pass
# ----------------------------------------------------------------------

def _jax_louvain(edges, weights, n):
    """JAX's louvain_host labels, and each of its sequential passes'
    inputs and labels."""
    passes, real = [], jc._louvain_one_level

    def record(*args):
        lab = real(*args)
        passes.append((args, lab))
        return lab

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jc, "_louvain_one_level", record)
        labels = jc.louvain_host(edges, weights, n)
    return labels, passes


@pytest.fixture(scope="module")
def jax_louvain():
    """Each graph's JAX Louvain, run once for the module."""
    cache = {}

    def get(graph):
        if graph not in cache:
            edges, weights, n = GRAPHS[graph]()
            cache[graph] = (edges, weights, n) + _jax_louvain(edges,
                                                              weights, n)
        return cache[graph]
    return get


@pytest.mark.parametrize("graph", ["jaccard", "equal", "wide", "large"])
def test_native_pass_matches_jax(graph, jax_louvain):
    """Fed each JAX pass's CSR adjacency, degrees and 2m, the native
    pass returns that pass's labels exactly (int64), phase by phase, and
    counts the work it did."""
    edges, weights, n, _, passes = jax_louvain(graph)
    assert passes
    counters = {}
    for (indptr, nbr, w, deg, two_m), want in passes:
        got = tc._louvain_one_level(indptr, nbr, w, deg, two_m, counters)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert counters["louvain_sweeps"] >= len(passes)
    assert counters["louvain_visits"] >= n
    assert 0 < counters["louvain_moves"] <= counters["louvain_visits"]
    if graph == "wide":
        # some node sees more than 128 neighbours in one community in
        # the first pass's result: its sum took the recursive split
        (indptr, nbr, *_), lab = passes[0]
        src = np.repeat(np.arange(n), np.diff(indptr))
        same = lab[src] == lab[nbr]
        assert np.bincount(src[same], minlength=n).max() > 128


@pytest.mark.parametrize("method", ["louvain_host", "auto"])
def test_louvain_on_the_large_graph_matches_jax(method, jax_louvain):
    """louvain_host and communities_from_edges(method="auto") on 4,000
    nodes and over 500,000 Jaccard edges equal JAX's; each Louvain call
    is a span louvain whose counters the native passes filled."""
    edges, weights, n, labels, _ = jax_louvain("large")
    assert len(edges) >= 500_000
    stats = PipelineStats()
    if method == "louvain_host":
        np.testing.assert_array_equal(
            tc.louvain_host(edges, weights, n, stats=stats), labels)
        assert len([sp for sp in stats.spans if sp[0] == "louvain"]) == 1
    else:
        j = jc.communities_from_edges(edges, weights, n, min_size=3,
                                      method="auto")
        t = tc.communities_from_edges(edges, weights, n, min_size=3,
                                      method="auto", device="cpu",
                                      stats=stats)
        assert len(j) > 2
        assert [c.tolist() for c in t] == [c.tolist() for c in j]
        # union3: the full graph's call and the LP community graph's
        assert len([sp for sp in stats.spans if sp[0] == "louvain"]) == 2
    assert stats.counters["louvain_visits"] >= n
    assert stats.counters["louvain_moves"] > 0


def test_segment_sums_match_reduceat():
    """The native per-community sum is np.add.reduceat's, bit for bit,
    on 6,000 random segments of 1-400 float64 values (plain loop,
    8-way blocks and recursive halves alike)."""
    rng = np.random.default_rng(11)
    lens = rng.integers(1, 401, 6_000)
    x = rng.random(int(lens.sum())) * 10.0 ** rng.integers(-3, 4,
                                                           int(lens.sum()))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.empty(len(starts))
    native.get_louvain_lib().eg3d_segment_sums(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts), len(x),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    want = np.add.reduceat(x, starts)
    np.testing.assert_array_equal(out, want)
    # a left-to-right sum differs on most long segments: the test sees
    # the order
    plain = np.array([sum(x[s:s + k].tolist()) for s, k in
                      zip(starts[:200], lens[:200])])
    assert (plain != want[:200]).sum() > 50
