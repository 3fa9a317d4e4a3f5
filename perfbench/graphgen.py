"""The benchmark's input graphs: the stochastic block model that stands in
for the Amazon co-purchase graphs, sampled from a seed.

The model is the one ``repro_torch.core.graph.synthetic_sbm`` draws from
(labels uniform over the classes; an edge between two nodes with
probability ``p_in`` inside a class and ``p_out`` across, ``p_in / p_out``
the configuration's ratio, scaled to the published average degree;
Gaussian class centres plus noise as features, each row of unit norm; the
published train and test counts drawn without overlap), frozen here so
that the yardstick does not move with the program.  The sampler never
forms the n x n matrix of pair probabilities: for each pair of classes it
draws the number of edges from its binomial and then that many distinct
node pairs, so a graph of the published size takes well under a second.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected graph, each edge once as (u, v) with u < v."""
    edges: np.ndarray        # (E, 2) int32
    features: np.ndarray     # (N, C0) float32
    labels: np.ndarray       # (N,) int32
    train_mask: np.ndarray   # (N,) bool
    test_mask: np.ndarray    # (N,) bool
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def nnz(self) -> int:
        """Nonzeros of the normalised adjacency with self loops."""
        return 2 * int(self.edges.shape[0]) + self.num_nodes


def _distinct_pairs(rng, a: np.ndarray, b: "np.ndarray | None",
                    count: int) -> np.ndarray:
    """``count`` distinct unordered node pairs drawn uniformly: one node of
    ``a`` and one of ``b``, or (``b`` None) two different nodes of ``a``."""
    same = b is None
    b = a if same else b
    got = np.zeros((0, 2), dtype=np.int64)
    while got.shape[0] < count:
        need = count - got.shape[0]
        draw = int(need * 1.1) + 16
        u = a[rng.integers(0, a.size, draw)]
        v = b[rng.integers(0, b.size, draw)]
        if same:
            keep = u != v
            u, v = u[keep], v[keep]
        pairs = np.stack([np.minimum(u, v), np.maximum(u, v)], axis=1)
        got = np.unique(np.concatenate([got, pairs]), axis=0)
    # the first ``count`` of a random order, so the cut is not by node id
    return got[rng.permutation(got.shape[0])[:count]]


def sbm_graph(nodes: int, avg_degree: float, num_classes: int,
              features: int, train: int, test: int, in_out_ratio: float,
              seed: int) -> Graph:
    """A graph of the model above from ``seed`` (any whole number >= 0)."""
    rng = np.random.default_rng(seed)
    n, k = int(nodes), int(num_classes)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    p_out = avg_degree / (n * (in_out_ratio / k + (1 - 1 / k)))
    p_in = in_out_ratio * p_out
    members = [np.flatnonzero(labels == c) for c in range(k)]
    parts = []
    for a in range(k):
        for b in range(a, k):
            na, nb = members[a].size, members[b].size
            pairs = na * (na - 1) // 2 if a == b else na * nb
            count = int(rng.binomial(pairs, p_in if a == b else p_out))
            if count:
                parts.append(_distinct_pairs(
                    rng, members[a], None if a == b else members[b], count))
    edges = np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)
    edges = edges[np.lexsort((edges[:, 1], edges[:, 0]))].astype(np.int32)

    centers = rng.normal(0.0, 1.0, size=(k, features)).astype(np.float32)
    feats = centers[labels] + rng.normal(
        0.0, 1.2, size=(n, features)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8

    order = rng.permutation(n)
    train_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[order[:train]] = True
    test_mask[order[train:train + test]] = True
    return Graph(edges, feats.astype(np.float32), labels, train_mask,
                 test_mask, k)
