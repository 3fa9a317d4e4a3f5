"""The span log of ``repro_torch.analysis.trace`` on the Parallel ADMM
trainer: spans nest and share their step's id, self times sum to the
step, nothing is kept while the log is off, the ``host_reads`` counter
agrees with the op trace's marked reads, the spans line up with
torch.profiler's ops on the CPU, and over two gloo ranks the ``comm.*``
spans are the transport's own clock (``ProcessTransport.time_s``)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import trace
from repro_torch.core import gcn, graph
from repro_torch.core.parallel import (ParallelADMMTrainer, TrainerConfig,
                                       _lane_search)
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train_gcn

DIMS = (16, 32, 4)
PHASES = {"admm.inputs", "admm.w_update", "admm.z_update", "admm.z_last",
          "admm.u_update"}
LAYOUT = {"layout.partition_quality", "layout.community",
          "layout.device_layout", "layout.community_data",
          "layout.first_iterates", "layout.plan"}
PROBE_SITES = ("backtracking", "lane-search")


def _graph(parts):
    g, _ = graph.synthetic_powerlaw_communities(
        parts, nodes_per_part=16, size_skew=1.0, feat_dim=DIMS[0], seed=0)
    return g


def _trainer(mesh=None, parts=3):
    g = _graph(parts)
    part = graph.partition_graph(g.num_nodes, g.edges, parts, seed=0,
                                 method="multilevel")
    return ParallelADMMTrainer(
        gcn.GCNConfig(layer_dims=DIMS), ADMMConfig(), g, num_parts=parts,
        seed=0, part=part, device="cpu", mesh=mesh,
        config=TrainerConfig.packed(use_kernel=True))


@pytest.fixture(scope="module")
def two_steps():
    """A one-shard trainer built and stepped twice under one span log."""
    with trace.spans() as log:
        tr = _trainer()
        tr.step()
        tr.step()
    return tr, log


def test_spans_nest_and_share_their_step(two_steps):
    _, log = two_steps
    assert log.n_steps == 2 and trace.SPANS is None
    roots = [i for i, n in enumerate(log.names) if n == trace.STEP]
    assert [log.steps[i] for i in roots] == [0, 1]
    for i, name in enumerate(log.names):
        assert 0 <= log.end_ns[i] - log.start_ns[i]
        p = log.parents[i]
        if p < 0:
            assert name in (trace.STEP, "layout")
            continue
        assert log.start_ns[p] <= log.start_ns[i] <= log.end_ns[i] \
            <= log.end_ns[p]
        assert log.steps[i] == log.steps[p]
        if log.names[p] == trace.STEP:
            assert name in PHASES
        if name == "admm.probe":
            assert log.names[p] in {"admm.w_update", "admm.z_update",
                                    "admm.z_last"}
            assert log.sites[i] in PROBE_SITES
        if name == "host.read":
            assert log.names[p] == "admm.probe"
            assert log.sites[i] == log.sites[p]
    for r in roots:
        kids = [log.names[i] for i in range(len(log)) if log.parents[i] == r]
        assert set(kids) == PHASES
        layers = [(log.names[i], log.layers[i]) for i in range(len(log))
                  if log.parents[i] == r and log.layers[i] is not None]
        assert layers == [("admm.w_update", 0), ("admm.w_update", 1),
                          ("admm.z_update", 1)]


def test_self_times_sum_to_the_step(two_steps):
    _, log = two_steps
    own = log.self_ns()
    for step in (0, 1):
        idx = [i for i in range(len(log)) if log.steps[i] == step]
        root = [i for i in idx if log.names[i] == trace.STEP]
        assert len(root) == 1
        total = log.end_ns[root[0]] - log.start_ns[root[0]]
        assert all(own[i] >= 0 for i in idx)
        assert sum(own[i] for i in idx) == total
    rows = log.summary([0, 1])
    assert sum(r["self_s"] for r in rows.values()) == \
        pytest.approx(rows[trace.STEP]["host_s"], rel=1e-12)
    assert rows[trace.STEP]["count"] == 2


def test_constructor_spans(two_steps):
    _, log = two_steps
    root = log.names.index("layout")
    assert log.parents[root] == -1 and log.steps[root] == -1
    kids = {log.names[i] for i in range(len(log)) if log.parents[i] == root}
    assert kids == LAYOUT
    assert all(log.steps[i] == -1 for i in range(len(log))
               if log.names[i].startswith("layout"))


def test_off_keeps_nothing(two_steps):
    tr, log = two_steps
    assert trace.SPANS is None
    a, b = trace.span(trace.STEP), trace.span("admm.w_update", l=1)
    assert a is b
    with a:
        pass
    with trace.marked("transport-staging"):
        pass
    idle = trace.SpanLog()
    n = len(log)
    tr.step()
    assert len(idle) == 0 and idle.counts == {} and len(log) == n
    with trace.spans() as empty:
        pass
    assert len(empty) == 0 and empty.counts == {} and empty.n_steps == 0
    with trace.spans():
        with pytest.raises(RuntimeError):
            trace.spans().__enter__()
    assert trace.SPANS is None


def test_host_reads_are_the_op_traces_marked_reads(two_steps):
    tr, _ = two_steps
    with trace.record() as tape, trace.spans() as log:
        tr.step()
    marked = [e for e in tape if e.host_read and e.probe in PROBE_SITES]
    assert [e for e in tape if e.host_read and e.probe is None] == []
    assert log.total("host_reads") == len(marked) >= 11
    for site in PROBE_SITES:
        assert log.counts[f"host_reads.{site}"] == \
            sum(e.probe == site for e in marked)
    # one decision a read, each its own host.read span
    assert log.names.count("host.read") == len(marked)


def test_spans_hold_the_profilers_ops(two_steps):
    """Every aten op the CPU profiler records inside an ``admm.*`` span
    lies within that span, ±0.2 ms, on the joined clock."""
    from torch.profiler import ProfilerActivity, profile
    tr, _ = two_steps
    with trace.spans() as log:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.step()
            tr.step()
    start = prof.profiler.kineto_results.trace_start_ns()

    def us(t):
        return (log.wall_ns(t) - start) * 1e-3

    spans = sorted((us(s), us(e), n) for n, s, e in
                   zip(log.names, log.start_ns, log.end_ns)
                   if n.startswith("admm."))
    steps = [(a, b) for a, b, n in spans if n == trace.STEP]
    ops = [e for e in prof.events() if e.name.startswith("aten::")
           and (e.cpu_parent is None
                or not e.cpu_parent.name.startswith("aten::"))]
    assert len(ops) > 100
    slack = 200.0
    for op in ops:
        a, b = op.time_range.start, op.time_range.end
        assert any(s - slack <= a and b <= e + slack for s, e in steps), \
            op.name
        mid = 0.5 * (a + b)
        inner = [(s, e) for s, e, _ in spans if s <= mid <= e]
        s, e = min(inner, key=lambda x: x[1] - x[0])
        assert s - slack <= a and b <= e + slack, op.name


def test_lane_search_keeps_its_probes():
    """The probe-spanned lane search takes the doublings, objective
    evaluations and reads of the plain loop it replaced."""
    admm = ADMMConfig(max_backtracks=5)
    rng = np.random.default_rng(0)
    for _ in range(20):
        need = torch.as_tensor(rng.uniform(0.1, 200.0, size=4),
                               dtype=torch.float32)
        calls = []

        def accepted(step, need=need, calls=calls):
            calls.append(step.clone())
            return step >= need

        step0 = torch.ones(4)
        with trace.spans() as log:
            got = _lane_search(accepted, step0, admm)
        ref_calls, reads = [], 0
        step = step0
        done = accepted(step)
        ref_calls.append(calls.pop())
        for _ in range(admm.max_backtracks):
            reads += 1
            if bool(done.all()):
                break
            step = torch.where(done, step, step * admm.backtrack_growth)
            done = done | accepted(step)
            ref_calls.append(calls.pop())
        assert torch.equal(got, step)
        assert len(calls) == len(ref_calls)
        assert all(torch.equal(a, b) for a, b in zip(calls, ref_calls))
        assert log.total("host_reads") == reads
        assert log.names.count("admm.probe") == len(ref_calls)


def test_profile_prints_phases_and_reads(two_steps):
    tr, _ = two_steps
    with trace.spans() as log:
        tr.step()
    line = train_gcn.phase_line(log)
    assert line.startswith("phases (host ms): admm.step ")
    for name in PHASES | {"admm.probe", "comm.allgather"}:
        assert name in line
    assert "layout" not in line and "host.read" not in line
    assert line.endswith(f"host reads {log.total('host_reads')}")


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def _rank_comm(rank, store, out):
    torch.set_num_threads(1)
    mesh = mesh_lib.init_process_mesh(rank, 2, "gloo", store, device="cpu")
    try:
        tr = _trainer(mesh, parts=4)
        tr.step()
        t0 = tr.comm.time_s
        with trace.spans() as log:
            tr.step()
        rows = log.summary()
        comm = {n: r["host_s"] for n, r in rows.items()
                if n.startswith("comm.")}
        parents = {log.names[log.parents[i]] for i, n in
                   enumerate(log.names) if n.startswith("comm.")}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump({"time_s": tr.comm.time_s - t0, "comm": comm,
                       "parents": sorted(parents),
                       "steps": sorted(set(log.steps))}, f)
    finally:
        mesh_lib.destroy(mesh)


def test_comm_spans_are_the_transports_clock(tmp_path):
    mesh_lib.run_ranks(_rank_comm, 2, (str(tmp_path),), timeout=120)
    for rank in range(2):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert set(got["comm"]) == {"comm.exchange", "comm.sum"}
        total = sum(got["comm"].values())
        assert got["time_s"] > 0
        assert abs(total - got["time_s"]) <= 0.01 * got["time_s"]
        assert set(got["parents"]) <= PHASES | {"admm.probe"}
        assert got["steps"] == [0]
