"""The inputs drawn from the seed: the SBM stand-in and the community
assignment."""
import numpy as np
import pytest

import graphgen
import partition


def graph(seed, n=1200):
    return graphgen.sbm_graph(n, 20.0, 8, 16, 100, 200, 12.0, seed)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_graph_from_seed(seed):
    g, h = graph(seed), graph(seed)
    assert np.array_equal(g.edges, h.edges)
    assert np.array_equal(g.features, h.features)
    e = g.edges
    assert (e[:, 0] < e[:, 1]).all()
    assert len(np.unique(e, axis=0)) == len(e)
    assert 2 * len(e) / g.num_nodes == pytest.approx(20.0, rel=0.1)
    assert g.train_mask.sum() == 100 and g.test_mask.sum() == 200
    assert not (g.train_mask & g.test_mask).any()
    np.testing.assert_allclose(np.linalg.norm(g.features, axis=1), 1.0,
                               rtol=1e-5)


def test_edges_follow_the_classes():
    g = graph(3)
    same = g.labels[g.edges[:, 0]] == g.labels[g.edges[:, 1]]
    # 12 times likelier inside a class over 8 classes: 12/8 / (12/8 + 7/8)
    assert same.mean() == pytest.approx(12 / 19, abs=0.05)


@pytest.mark.parametrize("m", [1, 3, 4])
def test_partition_contract(m):
    g = graph(5)
    part = partition.multilevel_partition(g.num_nodes, g.edges, m, seed=5)
    assert part.dtype == np.int32 and part.shape == (g.num_nodes,)
    sizes = np.bincount(part, minlength=m)
    assert len(sizes) == m and sizes.max() <= -(-g.num_nodes // m)
    again = partition.multilevel_partition(g.num_nodes, g.edges, m, seed=5)
    assert np.array_equal(part, again)
    if m > 1:
        cut = (part[g.edges[:, 0]] != part[g.edges[:, 1]]).mean()
        assert cut < 1 - 1 / m      # better than a random assignment
