"""Community detection of the port against the JAX package: the same
communities, in the same order, for every method, on planted-partition
graphs with Jaccard-like weights, with all-equal weights (where label
propagation's tie rule decides), and just above JAX's
LP_DENSE_MAX_NODES (where JAX switches from its dense scoreboard to its
sparse form; the port has the sparse form only).  Exact equality: the
port sums each (receiver, label) bucket in the same order as JAX's CPU
scatter-add, so equal scores stay equal on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.matching import communities as jc
from edgegraph3d_tpu_torch.matching import communities as tc


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


GRAPHS = {
    "jaccard": lambda: _planted(12, 9, 0.6, False, 0),
    "equal": lambda: _planted(12, 9, 0.6, True, 1),
    "above_dense": lambda: _planted(2050, 8, 0.5, False, 2),
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
