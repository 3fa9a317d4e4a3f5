"""The plain reference of one Parallel ADMM iteration against the port's
CPU path on a small seeded graph, on one shard and on four loopback
shards: each of the port's first steps from the same state, its
aggregations and its first iterates, within the cells' limits.  Its
sparse Ã against a dense one built here, and its size at ogbn-arxiv's
169,343 nodes: no tensor of N x N elements, and on the card (``cuda``
marker) a step in under half the card's memory."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import check
import driver
import graphgen
import partition
import program
import reference
from conftest import HERE, small_spec

# float32 round-off of a leaf's norm after one iteration: the sparse and
# the dense product differ by the order of their sums alone
ROUNDOFF = 1e-6
LIMITS = json.loads((HERE / "workloads" / "computers-admm-1gpu.json")
                    .read_text())["limits"]


@pytest.mark.parametrize("parts,shards", [(3, 1), (4, 4)])
def test_reference_follows_the_port(parts, shards):
    spec = small_spec("computers-admm-1gpu", nodes=1500)
    wl = dict(spec["workload"], parts=parts, shards=shards)
    cfg = spec["config"]
    seed = 2**31 + 29
    graph, part = driver.make_inputs(cfg, wl, seed)
    trainer = program.build_trainer(cfg, wl, graph, part, seed, "cpu")
    nodes = program.NodeReader(trainer)
    states, calls = [nodes.state(trainer.state)], []
    for _ in range(3):
        sink = []
        with program.capture_aggregations(sink):
            trainer.step()
        calls.append([nodes.blocked_rows(out) for _, out in sink])
        states.append(nodes.state(trainer.state))
    assert all(len(c) == 3 for c in calls)
    prob = reference.build_problem(graph, part, cfg["layer_dims"],
                                   driver.admm_of(cfg), "cpu")
    got = check.judge(prob, seed, states, calls)
    for name, limit in LIMITS.items():
        assert got[name] <= limit, (name, got[name])
    # the steps really move: Z_L and U each step, W_L from the second
    assert got["iter_err"] > 0


def test_reference_steps_are_deterministic_and_move():
    spec = small_spec("photo-admm-1gpu", nodes=300, dims=(32, 40, 5))
    cfg, wl = spec["config"], spec["workload"]
    graph, part = driver.make_inputs(cfg, wl, 4)
    p = reference.build_problem(graph, part, cfg["layer_dims"],
                                driver.admm_of(cfg), "cpu")
    s0 = reference.init_state(p, 4)
    s1, aggs = reference.iteration(p, s0)
    t1, _ = reference.iteration(p, s0)
    for a, b in zip(s1.zs + [s1.u], t1.zs + [t1.u]):
        assert torch.equal(a, b)
    assert float(torch.linalg.norm(s1.zs[-1] - s0.zs[-1])) > 0
    assert float(torch.linalg.norm(s1.u)) > 0
    # Ã Z from the sparse adjacency equals the edge-list sum
    x = p.x
    deg = np.bincount(graph.edges.ravel(), minlength=graph.num_nodes) + 1.0
    want = x / torch.as_tensor(deg, dtype=torch.float32)[:, None]
    d = torch.as_tensor(deg ** -0.5, dtype=torch.float32)
    e = torch.as_tensor(graph.edges.astype(np.int64))
    want = want.clone()
    want.index_add_(0, e[:, 0], x[e[:, 1]] * (d[e[:, 0]] * d[e[:, 1]])[:, None])
    want.index_add_(0, e[:, 1], x[e[:, 0]] * (d[e[:, 0]] * d[e[:, 1]])[:, None])
    torch.testing.assert_close(aggs["in"][0], want, rtol=1e-5, atol=1e-6)


def dense_adjacency(num_nodes, edges):
    """The dense Ã of the paper's definition, built here entry by entry
    from the edge list: a_ij = 1 for an edge either way, the diagonal
    cleared before the degree is taken, then (a + I) scaled by d_i d_j."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64))
    a = torch.zeros((num_nodes, num_nodes), dtype=torch.float32)
    a[e[:, 0], e[:, 1]] = 1.0
    a[e[:, 1], e[:, 0]] = 1.0
    a.fill_diagonal_(0.0)
    d = torch.rsqrt(a.sum(dim=1) + 1.0)
    a.fill_diagonal_(1.0)
    return a * d[:, None] * d[None, :]


def test_sparse_adjacency_is_the_dense_one_bitwise():
    rng = np.random.default_rng(2**31 + 3)
    n = 300
    e = rng.integers(0, n, size=(1500, 2))
    # repeated edges, in the same and in the other direction, self loops
    e = np.concatenate([e, e[:40], e[40:80, ::-1],
                        np.repeat(np.arange(0, n, 7), 2).reshape(-1, 2)])
    assert (e[:, 0] == e[:, 1]).any()
    a = reference.normalized_adjacency(n, e, "cpu")
    assert a.layout == torch.sparse_csr
    want = dense_adjacency(n, e)
    got = a.to_dense()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # every stored entry is a nonzero of Ã, and every nonzero is stored
    assert a.values().numel() == int(torch.count_nonzero(want))


def test_sparse_iteration_follows_a_dense_one():
    spec = small_spec("photo-admm-1gpu", nodes=400, dims=(32, 40, 5))
    cfg, wl = spec["config"], spec["workload"]
    graph, part = driver.make_inputs(cfg, wl, 2**31 + 17)
    sparse = reference.build_problem(graph, part, cfg["layer_dims"],
                                     driver.admm_of(cfg), "cpu")
    a = dense_adjacency(graph.num_nodes, graph.edges)
    dense = dataclasses.replace(
        sparse, a=a,
        coupling=[a[r][:, l] for r, l in zip(sparse.rows, sparse.lanes)])
    for blk, want in zip(sparse.coupling, dense.coupling):
        assert torch.equal(blk.to_dense(), want)
    s0, d0 = (reference.init_state(q, 2**31 + 17) for q in (sparse, dense))
    s1, s_aggs = reference.iteration(sparse, s0)
    d1, d_aggs = reference.iteration(dense, d0)
    # the two differ by the order of the sums alone: within float32
    # round-off of each leaf's norm
    for x, y in zip(check._leaves(s0) + check._leaves(s1),
                    check._leaves(d0) + check._leaves(d1)):
        err = check._norm(x[1] - y[1]) / max(check._norm(y[1]), 1e-30)
        assert err < ROUNDOFF, (x[0], err)
    # and the line searches decide alike
    for x, y in zip(s1.taus + s1.thetas, d1.taus + d1.thetas):
        assert torch.equal(x, y)
    for x, y in zip(s_aggs["in"] + [s_aggs["pen"]],
                    d_aggs["in"] + [d_aggs["pen"]]):
        assert check._norm(x - y) / check._norm(y) < ROUNDOFF


class LargestTensor(TorchDispatchMode):
    """Records the most elements of any tensor an operation returns while
    the mode is on (a sparse tensor's by its stored entries)."""

    def __init__(self):
        super().__init__()
        self.most = (0, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                n = t.numel() if t.layout == torch.strided else t._nnz()
                self.most = max(self.most, (n, str(func)),
                                key=lambda x: x[0])
        return out


# ogbn-arxiv's widths (Hu et al. 2020, the paper's GCN at hidden 1000) and
# the Computers configuration's constants
ARXIV_DIMS = (128, 1000, 40)
ARXIV_ADMM = reference.Admm(1e-3, 1e-3, 1.0, 2.0, 30, 8, 1e-6)


def arxiv_graph(seed):
    """ogbn-arxiv's published size (169,343 nodes, average degree 13.77,
    40 classes, 128 features) as the benchmark's SBM."""
    return graphgen.sbm_graph(169343, 13.77, 40, 128, 1000, 1000, 12.0,
                              seed)


def _held(p) -> list:
    """Every tensor a ``Problem`` holds, a sparse one by its parts."""
    out = []
    for t in [p.a, p.x, p.labels, p.train, p.denom] + p.lanes + p.rows \
            + p.coupling:
        if t.layout == torch.sparse_csr:
            out += [t.crow_indices(), t.col_indices(), t.values()]
        else:
            out.append(t)
    return out


def test_build_problem_at_arxiv_size_holds_no_square():
    graph = arxiv_graph(2**31 + 23)
    n = graph.num_nodes
    cap = 4 * (graph.nnz + n * 128)
    assert cap < n * n // 100
    # three communities by label: no partitioner runs
    with LargestTensor() as seen:
        p = reference.build_problem(graph, graph.labels % 3, ARXIV_DIMS,
                                    ARXIV_ADMM, "cpu")
    assert seen.most[0] <= cap, seen.most
    assert max(t.numel() for t in _held(p)) <= cap
    assert p.a.values().numel() == graph.nnz
    assert sum(b.values().numel() for b in p.coupling) == graph.nnz


def test_reference_step_at_arxiv_size_forms_no_square():
    # init, one iteration and the judgement of that step, at ogbn-arxiv's
    # node count; the widths are cut (hidden 16) to keep the test small,
    # as no N x N tensor could depend on them
    seed = 2**31 + 29
    graph = arxiv_graph(seed)
    n = graph.num_nodes
    cap = 4 * (graph.nnz + n * 128)
    p = reference.build_problem(
        graph, graph.labels % 3, (128, 16, 40),
        dataclasses.replace(ARXIV_ADMM, fista_iters=2), "cpu")
    with LargestTensor() as seen:
        s0 = reference.init_state(p, seed)
        s1, aggs = reference.iteration(p, s0)
        ids = np.arange(n)
        calls = [[(ids, x) for x in aggs["in"] + [aggs["pen"]]]]
        got = check.judge(p, seed, [vars(s0), vars(s1)], calls)
    assert seen.most[0] <= cap, seen.most
    # the reference judges its own step as its own
    assert got["init_err"] == 0 and got["iter_err"] == 0
    assert got["agg_err"] == 0


def arxiv_reference_step(device) -> dict:
    """The reference alone at ogbn-arxiv's published size on the card:
    its widths 128 → 1000 → 40, M = 3 from ``partition.py``;
    ``build_problem``, ``init_state`` and one ``iteration``.  Returns the
    host seconds of the partitioner, the seconds of each of the three and
    the card's peak bytes over them."""
    seed = 2**31 + 31
    graph = arxiv_graph(seed)
    t = time.perf_counter()
    part = partition.multilevel_partition(graph.num_nodes, graph.edges, 3,
                                          seed)
    out = {"partition_s": time.perf_counter() - t}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t = time.perf_counter()
    p = reference.build_problem(graph, part, ARXIV_DIMS, ARXIV_ADMM, device)
    torch.cuda.synchronize(device)
    out["build_problem_s"] = time.perf_counter() - t
    t = time.perf_counter()
    s0 = reference.init_state(p, seed)
    torch.cuda.synchronize(device)
    out["init_state_s"] = time.perf_counter() - t
    t = time.perf_counter()
    s1, _ = reference.iteration(p, s0)
    torch.cuda.synchronize(device)
    out["iteration_s"] = time.perf_counter() - t
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    out["card_bytes"] = torch.cuda.get_device_properties(device).total_memory
    out["finite"] = all(bool(torch.isfinite(x).all())
                        for x in s1.weights + s1.zs + [s1.u])
    out["nnz"] = graph.nnz
    return out


@pytest.mark.cuda
def test_reference_step_at_arxiv_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = arxiv_reference_step(torch.device("cuda"))
    assert got["finite"]
    assert got["peak_bytes"] < got["card_bytes"] / 2, got
