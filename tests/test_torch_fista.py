"""The route of the trainer's Z_L prox (eq. 7) and the FISTA kernel's launch
geometry, on the CPU.

A step takes the plain host loop (``core.parallel.fista_lanes``) on the
CPU, under ``use_kernel`` recorded as the kernel event it stands in for,
and counts ``fista.plain`` in the span log.  With the kernel's launcher
stood in for by the plain solver (the CUDA kernel has no CPU mode;
``tests/test_torch_fista_cuda.py`` holds it against the plain solver on the
card), a step routed to the kernel counts ``fista.kernel``, makes no probe
and no host read inside ``admm.z_last``, and gives the plain path's Z_L.
``kernels.fista.layout`` mirrors the CUDA source's geometry, rows that do
not fit shared memory going to a workspace; the launcher refuses what the
kernel does not take.
"""
import dataclasses

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import trace
from repro_torch.analysis.rules.kernel import (check_kernel_bounds,
                                               check_kernel_smem)
from repro_torch.core import gcn, graph, parallel
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.kernels import fista, ops

DIMS = (16, 32, 4)


def _trainer(use_kernel=True, n_shards=1):
    g, _ = graph.synthetic_powerlaw_communities(
        3, nodes_per_part=16, size_skew=1.0, feat_dim=DIMS[0], seed=0)
    part = graph.partition_graph(g.num_nodes, g.edges, 3, seed=0,
                                 method="multilevel")
    return ParallelADMMTrainer(
        gcn.GCNConfig(layer_dims=DIMS), ADMMConfig(), g, num_parts=3,
        seed=0, part=part, device="cpu", n_shards=n_shards,
        config=TrainerConfig.packed(use_kernel=use_kernel))


def _inside(log, i, name):
    """Whether span ``i`` lies inside a span called ``name``."""
    p = log.parents[i]
    while p >= 0:
        if log.names[p] == name:
            return True
        p = log.parents[p]
    return False


def _z_last_probes(log):
    return [i for i, n in enumerate(log.names)
            if n in ("admm.probe", "host.read")
            and _inside(log, i, "admm.z_last")]


@pytest.mark.parametrize("use_kernel,n_shards", [(True, 1), (False, 1),
                                                 (True, 3)])
def test_cpu_steps_take_the_plain_path(use_kernel, n_shards):
    tr = _trainer(use_kernel, n_shards)
    launches = fista.launches
    with trace.spans() as log:
        tr.step()
        tr.step()
    assert log.counts.get("fista.plain") == 2
    assert "fista.kernel" not in log.counts
    assert fista.launches == launches
    # the plain loop searches on the host: probes and reads in z_last
    assert _z_last_probes(log)


def test_kernel_route_reads_nothing_inside_z_last(monkeypatch):
    tr = _trainer()
    plain = tr.next_state()
    calls = []

    def launcher(b, u, labels, mask, z_init, denom, *, rho, growth, rtol,
                 max_backtracks, iters, stats=False):
        # the plain solver with the span log muted: what the kernel
        # computes from the arguments the wrapper hands it, without the
        # host loop's spans and reads
        calls.append(tuple(z_init.shape))
        assert labels.dtype == torch.int32 and not stats
        admm = dataclasses.replace(
            tr.admm, rho=rho, backtrack_growth=growth, backtrack_rtol=rtol,
            max_backtracks=max_backtracks, fista_iters=iters)
        log, trace.SPANS = trace.SPANS, None
        try:
            return parallel.fista_lanes(admm, b, u, labels, mask, z_init,
                                        denom), None, None
        finally:
            trace.SPANS = log

    # the wrapper's card route on CPU tensors, the launch stood in for
    monkeypatch.setattr(ops, "fista_lanes", ops._fista_kernel)
    monkeypatch.setattr(fista, "fista_lanes", launcher)
    with trace.spans() as log:
        tr.step()
    assert calls == [tuple(tr._body.z0.shape[:2]) + (DIMS[-1],)]
    assert log.counts.get("fista.kernel") == 1
    assert "fista.plain" not in log.counts
    assert _z_last_probes(log) == []
    z_last = log.names.index("admm.z_last")
    assert log.end_ns[z_last] >= log.start_ns[z_last]
    # the lane-search reads left are the hidden Z update's
    reads = [i for i, n in enumerate(log.names)
             if n == "host.read" and log.sites[i] == "lane-search"]
    assert all(_inside(log, i, "admm.z_update") for i in reads)
    assert log.counts.get("host_reads.lane-search", 0) == len(reads)
    assert torch.equal(tr.state.zs[-1], plain.zs[-1])
    for a, b in zip(tr.state.weights, plain.weights):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,c,cluster,rows,threads", [
    (4584, 10, 8, 573, 576),     # Amazon Computers' lanes, M = 3
    (2550, 8, 5, 510, 512),      # Amazon Photo's, M = 3
    (512, 8, 1, 512, 512),       # Photo at M = 16
    (17, 4, 1, 17, 32),
    (8896, 10, 8, 1112, 1024),   # the most rows resident at C = 10
    (8897, 10, 8, 1113, 1024),   # the fewest in the workspace
    (60000, 16, 8, 7500, 1024),
])
def test_layout_adapts_by_shape(n, c, cluster, rows, threads):
    lay = fista.layout(n, c)
    assert (lay["cluster"], lay["rows"], lay["threads"]) == (cluster, rows,
                                                             threads)
    assert cluster * rows >= n > (cluster - 1) * rows
    arrays = rows * (5 * c + 2)
    if lay["resident"]:
        assert lay["smem_bytes"] == 1120 + 4 * arrays and lay["work"] == 0
    else:
        assert lay["smem_bytes"] == 1120 and lay["work"] == cluster * arrays
    assert lay["smem_bytes"] <= fista.SMEM_LIMIT


def test_rows_past_shared_memory_go_to_the_workspace():
    assert fista.layout(8896, 10)["resident"]
    assert not fista.layout(8897, 10)["resident"]
    assert fista.layout(20000, 2)["resident"]
    assert not fista.layout(20000, 5)["resident"]
    # the launch spec follows the layout, and the kernel rules take it
    for n, c in ((4584, 10), (8897, 10)):
        spec = fista.spec(3, n, c, 8)
        lay = fista.layout(n, c)
        assert spec.grid == (lay["cluster"], 1, 3)
        assert spec.layout_words() == (lay["cluster"], lay["rows"],
                                       lay["threads"], lay["smem_bytes"])
        assert spec.flops == fista.work(3, n, c, 8)[0] == 36 * 8 * 3 * n * c
        assert not check_kernel_bounds(spec) and not check_kernel_smem(spec)


def test_cpu_trace_records_the_kernel_event():
    """Under ``use_kernel`` a recorded CPU step carries the kernel event
    the card's carries, with the plain route, and lints clean."""
    tr = _trainer()
    tape, exp = analysis.record_step(tr)
    events = [e for e in tape.of_kind("kernel") if e.name == "fista_lanes"]
    assert len(events) == 1 and events[0].info["route"] == "plain"
    k, n = tr._body.z0.shape[:2]
    assert events[0].info["spec"] == fista.spec(k, n, DIMS[-1],
                                                tr.admm.fista_iters)
    assert [t.shape for t in events[0].outputs] == [(k, n, DIMS[-1])]
    assert not analysis.analyze_trace(tape, exp).errors()
    off = _trainer(use_kernel=False)
    tape, _ = analysis.record_step(off)
    assert not [e for e in tape.of_kind("kernel") if e.name == "fista_lanes"]


def test_launcher_refuses_what_the_kernel_does_not_take():
    k, n, c = 2, 8, 3
    f = torch.zeros(k, n, c)
    lab, msk = torch.zeros(k, n, dtype=torch.int32), torch.ones(k, n)
    den = torch.tensor(4.0)
    kw = dict(rho=1e-3, growth=2.0, rtol=1e-6, max_backtracks=30, iters=8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fista.fista_lanes(f, f, lab, msk, f, den, **kw)
    cpu = torch.device("cpu")
    assert fista.check_operands(f, f, lab, msk, f, den, cpu) == (k, n, c)
    with pytest.raises(TypeError, match="labels"):
        fista.check_operands(f, f, lab.long(), msk, f, den, cpu)
    with pytest.raises(TypeError, match="z_init"):
        fista.check_operands(f, f, lab, msk, f.double(), den, cpu)
    with pytest.raises(ValueError, match="shape"):
        fista.check_operands(f[:, :4], f, lab, msk, f, den, cpu)
    with pytest.raises(ValueError, match="denom"):
        fista.check_operands(f, f, lab, msk, f, den[None], cpu)
    with pytest.raises(ValueError, match="contiguous"):
        fista.check_operands(f, f.transpose(1, 2).contiguous()
                             .transpose(1, 2), lab, msk, f, den, cpu)
    none = torch.zeros(0, n, c)
    with pytest.raises(ValueError, match="65,535 lanes"):
        fista.check_operands(none, none, lab[:0], msk[:0], none, den, cpu)
