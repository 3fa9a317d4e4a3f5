"""The plain reference of one Parallel ADMM iteration against the port's
CPU path on a small seeded graph, on one shard and on four loopback
shards: each of the port's first steps from the same state, its
aggregations and its first iterates, within the cells' limits."""
import json

import numpy as np
import pytest
import torch

import check
import driver
import program
import reference
from conftest import HERE, small_spec

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
    # Ã Z from the dense adjacency equals the edge-list sum
    x = p.x
    deg = np.bincount(graph.edges.ravel(), minlength=graph.num_nodes) + 1.0
    want = x / torch.as_tensor(deg, dtype=torch.float32)[:, None]
    d = torch.as_tensor(deg ** -0.5, dtype=torch.float32)
    e = torch.as_tensor(graph.edges.astype(np.int64))
    want = want.clone()
    want.index_add_(0, e[:, 0], x[e[:, 1]] * (d[e[:, 0]] * d[e[:, 1]])[:, None])
    want.index_add_(0, e[:, 1], x[e[:, 0]] * (d[e[:, 0]] * d[e[:, 1]])[:, None])
    torch.testing.assert_close(aggs["in"][0], want, rtol=1e-5, atol=1e-6)
