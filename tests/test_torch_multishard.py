"""The port's multi-shard Parallel ADMM trainer against the JAX package.

The JAX trainer runs on four forced host devices, one shard each; the port
runs the same four shards as logical shards of the CPU, its lanes stacked
and every exchange round a row copy.  One subprocess (JAX needs
``XLA_FLAGS`` before it is imported) builds the JAX trainer of every mode,
takes ``WARM`` = 5 steps, and writes the state, one more step from it, the
metrics and ``comm_stats`` to an ``.npz``; each test then takes the port's
step from that shared state.  Why the state after 5 steps:
tests/test_torch_parallel.py's docstring (a line search may flip between
reassociated programs at the initial state, where every residual is float
noise).  The port is held against the JAX *parallel* trainer, never the
serial one, and overlap to a tolerance (it regroups the neighbour sum).

Within the port: packed = strided bitwise at four shards, batch_fraction
1.0 = the full batch bitwise, and the stacked launch of the packed and
fused kernels' plain versions = one launch per shard, bitwise.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro_torch.convert import state_from_numpy
from repro_torch.core import gcn, messages
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS, PARTS, WARM = 4, 8, 5
DIMS = (16, 32, 4)
DEEP = (16, 32, 24, 4)      # two hidden layers: the eq. (5) Z objective
NU = RHO = 1e-3
# mode -> (preset, TrainerConfig fields, layer dims), the same in both
# packages
MODES = {
    "allgather": ("p2p", dict(transport="allgather", use_kernel=True), DIMS),
    "dense-allgather": ("dense", dict(use_kernel=True), DIMS),
    "dense-einsum": ("dense", dict(use_kernel=False), DIMS),
    "strided": ("p2p", dict(use_kernel=True), DIMS),
    "packed": ("packed", dict(use_kernel=True), DIMS),
    "fused": ("packed", dict(fused=True, use_kernel=True), DIMS),
    "comm-bf16": ("packed", dict(comm_bf16=True, use_kernel=True), DIMS),
    "minibatch": ("minibatch", dict(batch_fraction=0.5, stale_decay=0.7,
                                    use_kernel=True), DIMS),
    "overlap": ("packed", dict(overlap=True, use_kernel=True), DIMS),
    "deep-fused-overlap": ("packed", dict(fused=True, overlap=True,
                                          use_kernel=True), DEEP),
}

_WORKER = r"""
import json, sys
import jax
import numpy as np
from repro.core import gcn, graph, messages
from repro.core.parallel import AXIS, ParallelADMMTrainer, TrainerConfig
from repro.core.subproblems import ADMMConfig
from repro.util.compat import make_mesh

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) >= spec["shards"], jax.devices()
g, _ = graph.synthetic_powerlaw_communities(
    spec["parts"], nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
admm = ADMMConfig(nu=spec["nu"], rho=spec["rho"])
mesh = make_mesh((spec["shards"],), (AXIS,),
                 devices=jax.devices()[:spec["shards"]])

def leaves(prefix, state):
    flat = {}
    for name in ("weights", "zs", "taus", "thetas"):
        for i, x in enumerate(getattr(state, name)):
            flat[f"{prefix}/{name}/{i}"] = np.asarray(x)
    flat[f"{prefix}/u"] = np.asarray(state.u)
    return flat

def stats(jt):
    cs = dict(jt.comm_stats)
    if "overlap" in cs:
        # the port prices the overlap model on its own device: reprice the
        # reference's active plan at those constants
        got = cs["overlap"]
        dims = list(jt.cfg.layer_dims)
        gathered = [dims[0]] + dims[1:] + dims[2:] + [dims[-1], dims[-2]]
        cs["overlap"] = messages.overlap_stats(
            jt._active_plan, jt.layout.neighbor_mask, gathered,
            itemsize=got["model"]["itemsize"], enabled=got["enabled"],
            peak_flops=spec["peak_flops"], ici_bw=spec["link_bw"])
    return json.dumps(cs, default=lambda o: o.item(), sort_keys=True)

arrays, meta = {}, {}
for mode, (preset, kw, dims) in spec["modes"].items():
    jt = ParallelADMMTrainer(gcn.GCNConfig(tuple(dims)), admm, g,
                             spec["parts"], mesh=mesh, seed=0,
                             config=getattr(TrainerConfig, preset)(**kw))
    meta[mode] = {"stats0": stats(jt)}
    for _ in range(spec["warm"]):
        jt.step()
    arrays.update(leaves(f"{mode}/warm", jt.state))
    metrics = [float(x) for x in jt._metrics(jt.state)]
    metrics.append(float(jt._lagrangian(jt.state)))
    meta[mode]["warm_metrics"] = metrics
    meta[mode]["stats"] = stats(jt)
    if jt._sampler is not None:
        meta[mode]["round"] = jt._round
        arrays[f"{mode}/ages"] = np.array(jt._ages)   # step() adds in place
    jt.step()
    arrays.update(leaves(f"{mode}/next", jt.state))
    metrics = [float(x) for x in jt._metrics(jt.state)]
    metrics.append(float(jt._lagrangian(jt.state)))
    meta[mode]["next_metrics"] = metrics
arrays["meta"] = np.array(json.dumps(meta))
np.savez(out_path, **arrays)
print("WORKER_OK")
"""


def _case_graph():
    return jgraph.synthetic_powerlaw_communities(
        PARTS, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every mode's JAX run at four shards, from one subprocess."""
    path = tmp_path_factory.mktemp("multishard") / "reference.npz"
    spec = {"shards": SHARDS, "parts": PARTS, "nu": NU, "rho": RHO, "warm": WARM, "modes": MODES,
            "peak_flops": messages.PEAK_FLOPS, "link_bw": messages.LINK_BW}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARDS}",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _WORKER, str(path),
                           json.dumps(spec)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0 and "WORKER_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, json.loads(str(arrays.pop("meta")))


def _state(arrays, prefix):
    def group(name):
        keys = sorted((k for k in arrays if k.startswith(f"{prefix}/{name}/")),
                      key=lambda k: int(k.rsplit("/", 1)[1]))
        return [arrays[k] for k in keys]
    return (group("weights"), group("zs"), arrays[f"{prefix}/u"],
            group("taus"), group("thetas"))


def _port(mode, n_shards=SHARDS, **extra):
    g, _ = _case_graph()
    preset, kw, dims = MODES[mode]
    return ParallelADMMTrainer(
        gcn.GCNConfig(dims), ADMMConfig(nu=NU, rho=RHO), g, PARTS, seed=0,
        device="cpu", n_shards=n_shards,
        config=getattr(TrainerConfig, preset)(**dict(kw, **extra)))


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def _metrics(tt):
    out = [float(x) for x in tt._metrics(tt.state)]
    return out + [float(tt._lagrangian(tt.state))]


def _stats(tt):
    return json.dumps(tt.comm_stats, default=lambda o: o.item(),
                      sort_keys=True)


@pytest.fixture(scope="module")
def warmed(reference):
    """mode -> port trainer at the reference's state after WARM steps; a
    minibatching trainer first takes WARM steps of its own, so that its
    sampler's round and ages advance as the reference's did."""
    arrays, meta = reference
    cache = {}

    def get(mode):
        if mode not in cache:
            tt = _port(mode)
            for _ in range(WARM if tt._sampler is not None else 0):
                tt.step()
            tt.state = state_from_numpy(*_state(arrays, f"{mode}/warm"),
                                        device="cpu")
            cache[mode] = tt
        return cache[mode]
    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_one_step_from_shared_state_matches_reference_on_4_shards(
        reference, warmed, mode):
    """τ and θ equal, W/Z/U within rtol 1e-4 / atol 1e-5, metrics and the
    Lagrangian within 1e-5 relative, before and after the step."""
    arrays, meta = reference
    tt = warmed(mode)
    for name, a, b in zip(("train", "test", "residual", "lagrangian"),
                          meta[mode]["warm_metrics"], _metrics(tt)):
        assert _rel(a, b) <= 1e-5, (name, a, b)
    want = _state(arrays, f"{mode}/next")
    start = tt.state
    got = tt.next_state()
    assert [float(t) for t in got.taus] == [float(t) for t in want[3]]
    for a, b in zip(want[4], got.thetas):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(want[0] + want[1] + [want[2]],
                    got.weights + got.zs + (got.u,)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-5)
    tt.state = got
    try:
        for name, a, b in zip(("train", "test", "residual", "lagrangian"),
                              meta[mode]["next_metrics"], _metrics(tt)):
            assert _rel(a, b) <= 1e-5, (name, a, b)
    finally:
        tt.state = start


@pytest.mark.parametrize("mode", list(MODES))
def test_comm_stats_match_reference_on_4_shards(reference, warmed, mode):
    """Every ``comm_stats`` key equals the reference's — the wire of the
    schedule, the overlap pricing (on the port's device model) and the
    minibatch schedule — at construction and after WARM steps (the
    minibatch round, last batch and oldest age)."""
    _, meta = reference
    assert json.loads(_stats(_port(mode))) == \
        json.loads(meta[mode]["stats0"])
    assert json.loads(_stats(warmed(mode))) == \
        json.loads(meta[mode]["stats"])


def test_minibatch_round_and_ages_match_reference(reference, warmed):
    arrays, meta = reference
    tt = warmed("minibatch")
    assert tt._round == meta["minibatch"]["round"]
    np.testing.assert_array_equal(tt._ages, arrays["minibatch/ages"])


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

def test_packed_is_bitwise_strided_on_4_shards():
    """The packed wire moves the same rows as the strided exchange and the
    blocked views it rebuilds are the strided buffers: after two steps
    every iterate unpacks to the strided trainer's bit for bit."""
    strided, packed = _port("strided"), _port("packed")
    dl = packed.packed_layout
    assert dl.n_shards == SHARDS
    for _ in range(2):
        strided.step()
        packed.step()
    for a, b in zip(strided.state.zs + (strided.state.u,),
                    packed.state.zs + (packed.state.u,)):
        assert b.shape[0] == dl.total_rows
        np.testing.assert_array_equal(a.numpy(), dl.unpack_state(b.numpy()))
    for a, b in zip(strided.state.weights + strided.state.taus
                    + strided.state.thetas,
                    packed.state.weights + packed.state.taus
                    + packed.state.thetas):
        assert torch.equal(a, b)
    assert _metrics(strided) == _metrics(packed)


def test_full_batch_fraction_is_bitwise_the_full_batch():
    """batch_fraction = 1.0 samples every shard every round: the sampled
    program (restricted plan = the plan, lane masks 1, staleness 1) is the
    full-batch program bit for bit."""
    full = _port("packed")
    one = _port("minibatch", batch_fraction=1.0)
    for _ in range(3):
        full.step()
        one.step()
    for a, b in zip(full.state.weights + full.state.zs + (full.state.u,)
                    + full.state.taus + full.state.thetas,
                    one.state.weights + one.state.zs + (one.state.u,)
                    + one.state.taus + one.state.thetas):
        assert torch.equal(a, b)
    assert one.comm_stats["minibatch"]["rounds"] == 3


def _stacked_operands():
    """The trainer's stacked packed-wire operands at four shards and one
    exchange of Z_1: (blocks, offsets, live mask, receive planes, row
    counts, neighbour counts, the plan's own offsets, plan)."""
    tt = _port("packed")
    body = tt._body
    plan = body.plan
    csr = tt.layout.compress()
    local = torch.as_tensor(plan.localized_offsets(csr.ell_indices,
                                                   csr.ell_mask))
    x = body.from_plane(tt.state.zs[0])
    plane = body.gather(x, tt._full)
    return (body.ell_rows, body.offsets, body.ell_live, plane,
            body.ell_rcnt, body.ell_ncnt, local, plan)


@pytest.mark.parametrize("kind", ["packed", "fused"])
def test_stacked_launch_is_bitwise_per_shard_launches(kind):
    """One call over every shard's lanes (offsets shifted by s ·
    recv_plane_rows into the planes laid end to end) equals one call per
    shard on its own receive plane with the plan's offsets, bit for bit:
    each lane's output depends on its own operands only."""
    blocks, off, live, plane, rows, nbrs, local, plan = _stacked_operands()
    k, rpr = plan.lanes_per_shard, plan.recv_plane_rows
    assert plane.shape[0] == SHARDS * rpr
    w = torch.randn((plane.shape[1], 5),
                    generator=torch.Generator().manual_seed(0))

    def call(b, o, mk, p, r, n):
        if kind == "packed":
            return ops.community_spmm_ell_packed(b, o, mk, p, r, n)
        return ops.community_spmm_ell_fused(b, o, mk, p, w, r, n)

    stacked = call(blocks, off, live, plane, rows, nbrs)
    per_shard = []
    for s in range(SHARDS):
        lanes = slice(s * k, (s + 1) * k)
        assert torch.equal((off[lanes] - s * rpr) * live[lanes],
                           local[lanes] * live[lanes])
        per_shard.append(call(blocks[lanes], local[lanes], live[lanes],
                              plane[s * rpr:(s + 1) * rpr], rows[lanes],
                              nbrs[lanes]))
    assert torch.equal(stacked, torch.cat(per_shard))


def test_shards_must_divide_the_communities():
    with pytest.raises(ValueError, match="must divide"):
        _port("packed", n_shards=3)


def test_cli_trains_on_4_shards(capsys):
    """``--shards`` and the wire flags reach the trainer through the CLI."""
    from repro_torch.launch import train_gcn
    log = train_gcn.main(["--dataset", "amazon_photo_mini", "--parts", "4",
                          "--shards", "4", "--hidden", "16", "--epochs",
                          "2", "--compressed", "--packed", "--use-kernel",
                          "--fused", "--overlap", "--comm-bf16",
                          "--batch-fraction", "0.5", "--partitioner",
                          "bfs_kl", "--device", "cpu"])
    assert len(log["epoch"]) == 2
    assert all(np.isfinite(log[key]).all() for key in
               ("lagrangian", "residual", "train_acc", "test_acc"))
    out = capsys.readouterr().out
    assert "shards: 4 [p2p]" in out
    assert "fused True, overlap True, bf16 wire True, batch fraction 0.5" \
        in out
