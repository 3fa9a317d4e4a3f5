"""The counts the roofline and the model-FLOPs share rest on, pinned on a
hand-counted toy graph: the path 0 - 1 - 2 - 3 split into the
communities {0, 1} and {2, 3}."""
import numpy as np
import pytest
import torch

import counts
import driver
import graphgen
import reference

EDGES = np.array([[0, 1], [1, 2], [2, 3]], dtype=np.int32)
PART = np.array([0, 0, 1, 1], dtype=np.int32)


def toy_graph():
    feats = np.eye(4, 2, dtype=np.float32)
    return graphgen.Graph(EDGES, feats, np.array([0, 1, 0, 1], np.int32),
                          np.array([1, 1, 0, 0], bool),
                          np.array([0, 0, 1, 1], bool), 2)


def test_nonzeros_of_the_normalised_adjacency():
    g = toy_graph()
    # three edges both ways and four self loops
    assert g.nnz == 2 * 3 + 4 == 10
    a = reference.normalized_adjacency(4, EDGES, "cpu")
    # the entries Ã stores, each a nonzero
    assert a.values().numel() == g.nnz
    assert int(torch.count_nonzero(a.values())) == g.nnz


def test_aggregation_counts_nonzeros_not_blocks():
    flops, nbytes = counts.aggregation(rows=4, nnz=10, width=3)
    assert flops == 2 * 10 * 3
    # Z in and the output out (4 x 3 f32 each), a value and an index per
    # nonzero, a pointer per row and one more
    assert nbytes == 2 * 4 * 3 * 4 + 10 * (4 + 4) + 5 * 4


def test_step_aggregations():
    # Ã X is the same in every iteration: only the hidden inputs and the
    # dual's product are needed each step
    assert counts.step_aggregation_widths((767, 1000, 10)) == [1000, 1000]
    assert counts.step_aggregation_widths((2, 3, 4, 5)) == [3, 4, 4]


def test_bound_is_the_larger_of_the_two():
    assert counts.bound_s(67e12, 1.0, 67e12, 3.35e12) == 1.0
    assert counts.bound_s(1.0, 3.35e12, 67e12, 3.35e12) == 1.0


def test_coupling_rows_of_the_toy():
    # each community's neighbours are both communities: 2 x 4 rows
    got = driver.graph_counts(toy_graph(), PART)
    assert got == {"n": 4, "nnz": 10, "coupling_rows": 8}


def test_iteration_flops_by_hand():
    n, nnz, rows, fista = 4, 10, 8, 1
    hand = (
        2 * 10 * (3 + 3)                              # Ã Z1, Ã Z1'
        + 3 * (2 * 4 * 2 * 3 + 5 * 4 * 3) + 3 * 2 * 3   # W1
        + 3 * (2 * 4 * 3 * 2 + 6 * 4 * 2) + 3 * 3 * 2   # W2
        + (2 * 4 * 2 * 3 + 4 * 3) + 2 * 4 * 3 * 2       # target, relay
        + 3 * (2 * 4 * 3 * 2 + 2 * 10 * 2 + 6 * (4 * 3 + 8 * 2))
        + 3 * 4 * 3                                     # Z1's step
        + 2 * 4 * 3 * 2                                 # B
        + 1 * (3 * 20 + 2 * 3) * 4 * 2                  # FISTA
        + 2 * 4 * 3 * 2 + 3 * 4 * 2)                    # dual
    assert hand == 2328
    assert counts.admm_iteration_flops(n, nnz, (2, 3, 2), rows,
                                       fista) == hand


def test_published_size_needs_what_the_issue_reckoned():
    # Amazon Computers' widths: ~87 GFLOP an iteration, 84 of them in the
    # first layer's products; an aggregation ~1 GFLOP, bound by bytes
    f = counts.admm_iteration_flops(13752, 505000, (767, 1000, 10),
                                    3 * 13752, 8)
    assert 80e9 < f < 95e9
    fl, by = counts.aggregation(13752, 505000, 1000)
    assert fl == pytest.approx(1.01e9)
    assert by / 3.35e12 > fl / 67e12
