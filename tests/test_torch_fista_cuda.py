"""The FISTA prox kernel (``csrc/fista_lanes.cu``) on the card, held against
the plain host loop (``core.parallel.fista_lanes``) on the same CUDA
tensors (skipped without a card):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fista_cuda.py

Shapes: Amazon Computers' lanes (3 × 4,584 × 10), Amazon Photo's (3 ×
2,552 × 8), 16 lanes of 512 × 8, one of a rank's 3,438 × 10 (Computers
over four ranks) and two of 9,000 × 10, whose rows do not fit shared
memory and stream from the workspace; each with padding rows (mask, B, U
and Z zero).  Lanes cycle through four kinds: a train mask all zero, one
whose first probe accepts, one that accepts after a few doublings, and one
whose curvature keeps it past ``max_backtracks``.  Z_L agrees within 1e-5
of the lane's max |Z|, and each lane's final Lipschitz constant is bitwise
the plain loop's: both are ρ + 1 times the same powers of the growth and
of 0.9, rounded in f32 in the same order, so long as every decision
agrees.  Imports torch, numpy and the port only.
"""
import numpy as np
import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import trace
from repro_torch.core import gcn, graph, parallel
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.kernels import build, community_spmm, fista, ops

pytestmark = pytest.mark.cuda

KINDS = ("zero_mask", "first_probe", "doublings", "past_cap")
# train-mask scale of each kind over denom = 1,000: the cross-entropy's
# curvature is at most scale / (2 denom)
SCALE = {"zero_mask": 0.0, "first_probe": 1.0, "doublings": 1e4,
         "past_cap": 1e9}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kind(m, first):
    return KINDS[(m + first) % len(KINDS)]


def _lanes(k, n, c, pad, seed, device, first=0):
    rng = np.random.default_rng(seed)
    z = (2.0 * rng.normal(size=(k, n, c))).astype(np.float32)
    b = (z + 0.1 * rng.normal(size=(k, n, c))).astype(np.float32)
    u = (1e-3 * rng.normal(size=(k, n, c))).astype(np.float32)
    labels = rng.integers(0, c, size=(k, n)).astype(np.int32)
    mask = (rng.random((k, n)) < 0.3).astype(np.float32)
    for m in range(k):
        mask[m] *= SCALE[_kind(m, first)]
    for x in (z, b, u):
        x[:, n - pad:] = 0.0
    mask[:, n - pad:] = 0.0
    labels[:, n - pad:] = 0
    t = [torch.as_tensor(x, device=device) for x in (b, u, labels, mask, z)]
    return t + [torch.tensor(1000.0, device=device)]


def _plain(monkeypatch, admm, ops):
    """The plain loop's Z_L and its final Lipschitz constants."""
    found = []
    real = parallel._lane_search

    def spy(accepted, step0, admm):
        found.append(real(accepted, step0, admm))
        return found[-1]

    monkeypatch.setattr(parallel, "_lane_search", spy)
    z = parallel.fista_lanes(admm, *ops)
    monkeypatch.setattr(parallel, "_lane_search", real)
    return z, found[-1] * 0.9


def _kernel(admm, ops):
    return fista.fista_lanes(
        *ops, rho=admm.rho, growth=admm.backtrack_growth,
        rtol=admm.backtrack_rtol, max_backtracks=admm.max_backtracks,
        iters=admm.fista_iters, stats=True)


@pytest.mark.parametrize("max_backtracks,iters", [(6, 8), (6, 1), (30, 8)])
@pytest.mark.parametrize("k,n,c,pad,first", [
    (3, 4584, 10, 40, 0), (3, 2552, 8, 30, 0), (16, 512, 8, 20, 0),
    (1, 3438, 10, 10, 2), (2, 9000, 10, 50, 1)])
def test_kernel_matches_the_plain_loop(cuda_device, monkeypatch, k, n, c,
                                       pad, first, max_backtracks, iters):
    admm = ADMMConfig(rho=1e-3, max_backtracks=max_backtracks,
                      fista_iters=iters)
    ops = _lanes(k, n, c, pad, seed=k * n + c, device=cuda_device,
                 first=first)
    want, want_lip = _plain(monkeypatch, admm, ops)
    launches = fista.launches
    got, lip, probes = _kernel(admm, ops)
    torch.cuda.synchronize()
    assert fista.launches == launches + 1
    for m in range(k):
        scale = want[m].abs().max().item()
        err = (got[m] - want[m]).abs().max().item()
        assert err <= 1e-5 * scale, (m, _kind(m, first), err, scale)
    assert torch.equal(lip, want_lip), (lip, want_lip)
    assert torch.equal(got[:, n - pad:], torch.zeros_like(got[:, n - pad:]))
    probes = probes.tolist()
    cap = max_backtracks + 1
    for m in range(k):
        kind = _kind(m, first)
        if kind in ("zero_mask", "first_probe"):
            assert probes[m] == iters, (m, kind, probes[m])
        elif kind == "doublings":
            assert iters < probes[m] < iters * cap, (m, kind, probes[m])
        elif iters == 1 and max_backtracks == 6:
            assert probes[m] == cap, (m, kind, probes[m])


def test_layout_query_is_the_launcher_layout(cuda_device):
    for n, c in [(4584, 10), (2552, 8), (512, 8), (17, 4), (8896, 10),
                 (8897, 10), (20000, 2), (60000, 16)]:
        spec = fista.spec(3, n, c, 8)
        assert community_spmm.query_layout(spec) == spec.layout_words()
        assert fista.layout(n, c)["resident"] == (spec.smem_bytes > 1120)


def test_a_refused_launch_raises(cuda_device):
    ops_ = _lanes(1, 8897, 10, 0, seed=1, device=cuda_device)
    with pytest.raises(TypeError, match="z_init"):
        _kernel(ADMMConfig(), ops_[:4] + [ops_[4].double(), ops_[5]])
    with pytest.raises(ValueError, match="must not be negative"):
        fista.fista_lanes(*ops_, rho=1e-3, growth=2.0, rtol=1e-6,
                          max_backtracks=-1, iters=8)
    # rows past shared memory and no workspace: the C entry refuses
    out = torch.empty_like(ops_[4])
    with pytest.raises(RuntimeError, match="fista_lanes launch failed"):
        build.launch("fista_lanes", fista.LIB, fista.SYMBOL,
                     ops_ + [None, None, None, out],
                     [1, 8897, 10, 30, 8, 5e-4, 2.0, 1e-6, 1.001],
                     cuda_device, fista.ERRORS)


def test_trainer_step_runs_the_kernel(cuda_device, monkeypatch):
    """A one-shard packed step under ``use_kernel`` on the card: one launch,
    counted ``fista.kernel``, no probe or read in ``admm.z_last``, and the
    plain route's Z_L from the same state."""
    dims = (16, 32, 4)
    g, _ = graph.synthetic_powerlaw_communities(
        3, nodes_per_part=64, size_skew=1.0, feat_dim=dims[0], seed=0)
    part = graph.partition_graph(g.num_nodes, g.edges, 3, seed=0,
                                 method="multilevel")
    tr = ParallelADMMTrainer(
        gcn.GCNConfig(layer_dims=dims), ADMMConfig(), g, num_parts=3,
        seed=0, part=part, device=cuda_device,
        config=TrainerConfig.packed(use_kernel=True))
    with monkeypatch.context() as mp:
        mp.setattr(ops, "fista_lanes", parallel.fista_lanes)
        plain = tr.next_state()
    launches = fista.launches
    with trace.spans() as log:
        tr.step()
    torch.cuda.synchronize()
    assert fista.launches == launches + 1
    assert log.counts.get("fista.kernel") == 1
    assert "fista.plain" not in log.counts
    z_last = log.names.index("admm.z_last")
    assert all(log.parents[i] != z_last for i in range(len(log)))
    got, want = tr.state.zs[-1], plain.zs[-1]
    assert (got - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    for a, b in zip(tr.state.weights, plain.weights):
        assert torch.equal(a, b)
    # a recorded step carries the launch, on the card's route, with the
    # launch spec the library's layout query gives
    tape, _ = analysis.record_step(tr)
    events = [e for e in tape.of_kind("kernel") if e.name == "fista_lanes"]
    assert len(events) == 1 and events[0].info["route"] == "cuda"
    spec = events[0].info["spec"]
    assert community_spmm.query_layout(spec) == spec.layout_words()
