"""The port's one-device Parallel ADMM trainer against the JAX package.

Like with like, from a shared state, over one step: the JAX trainer runs on
a one-device mesh and the port on ``device="cpu"``; the port's
``use_kernel=False`` (gather-einsum) is held against JAX ``use_kernel=False``
and its ``use_kernel=True`` (on the CPU, the kernel's plain version) against
JAX ``use_kernel=True`` (off a TPU, the jnp oracle).

The backtracking searches branch on objective differences near
``backtrack_rtol = 1e-6``, so a reassociation alone can double a step size.
At the initial state every residual is float noise (Z is the forward pass
itself) and the first W search of the two packages does flip there.  The
shared state is therefore the JAX state after ``WARM`` = 5 steps of the
small case below; there every acceptance test of the W searches clears its
threshold by more than 2e-2 relative (W_1 rejects τ once, by 3.1e-2, then
accepts) and every lane of the θ search by more than 7e-4 — far from a
flip — so τ and θ must be equal (the three-layer case agrees on τ/θ from
3 to 8 warm-up steps alike).  The objective values and gradients that
decide those branches are also compared directly, branch-free.
"""
import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.core import graph as jgraph
from repro.core.parallel import AXIS
from repro.core.parallel import ParallelADMMTrainer as JaxTrainer
from repro.core.parallel import TrainerConfig as JaxConfig
from repro.core.subproblems import ADMMConfig as JaxADMM
from repro.core.subproblems import stale_weights as jax_stale_weights
from repro.kernels import ops as jops
from repro.util.compat import make_mesh
from repro_torch.convert import state_from_numpy, weights_from_numpy
from repro_torch.core import gcn
from repro_torch.core.parallel import ParallelADMMTrainer, TrainerConfig
from repro_torch.core.subproblems import ADMMConfig, stale_weights
from repro_torch.launch import train_gcn

WARM = 5
DIMS = (16, 32, 4)
NU = RHO = 1e-3

# ---------------------------------------------------------------------------
# TrainerConfig
# ---------------------------------------------------------------------------

INVALID = [
    dict(transport="bogus"),
    dict(transport="p2p", compressed=False),
    dict(packed=True, compressed=False),
    dict(packed=True, compressed=True, transport="allgather"),
    dict(overlap=True),
    dict(fused=True, compressed=True),
    dict(pad_mode="weird"),
    dict(adjacency_bf16=True, compressed=False),
    dict(compressed=True, packed=True, batch_fraction=0.0),
    dict(compressed=True, packed=True, batch_fraction=1.5),
    dict(compressed=True, batch_fraction=0.5),
    dict(stale_decay=0.0),
    dict(stale_decay=1.5),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(kw))
def test_invalid_configs_raise_the_reference_message(kw):
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        TrainerConfig(**kw)
    assert str(got.value) == str(want.value)


def test_fields_presets_and_cli_match_the_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(TrainerConfig) == fields(JaxConfig)
    for preset, kw in [("dense", {}), ("p2p", {}), ("packed", {}),
                       ("minibatch", {}), ("minibatch", dict(
                           batch_fraction=0.5, overlap=True)),
                       ("packed", dict(fused=True, use_kernel=True))]:
        assert dataclasses.asdict(getattr(TrainerConfig, preset)(**kw)) == \
            dataclasses.asdict(getattr(JaxConfig, preset)(**kw))
    ns = argparse.Namespace(compressed=True, transport=None, packed=True,
                            use_kernel=True, pad_mode="global", dataset="x")
    assert dataclasses.asdict(TrainerConfig.from_cli_args(ns)) == \
        dataclasses.asdict(JaxConfig.from_cli_args(ns))


@pytest.mark.parametrize("config", [
    TrainerConfig(), TrainerConfig.dense(), TrainerConfig.minibatch(),
    TrainerConfig.packed(comm_bf16=True),
    TrainerConfig.p2p(adjacency_bf16=True)],
    ids=["default", "dense", "minibatch", "comm_bf16", "adjacency_bf16"])
def test_unported_configs_raise_naming_the_roadmap(config):
    g, _ = _case_graph()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParallelADMMTrainer(gcn.GCNConfig(DIMS), ADMMConfig(), g, 8,
                            config=config, device="cpu")


def test_admm_config_and_stale_weights_match_the_reference():
    assert dataclasses.asdict(ADMMConfig()) == dataclasses.asdict(JaxADMM())
    ages = np.array([0, 1, 2, 5, 30])
    for decay in (0.5, 0.9, 1.0):
        want = np.asarray(jax_stale_weights(ages, decay))
        got = stale_weights(ages, decay)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# one step from a shared state
# ---------------------------------------------------------------------------

def _case_graph():
    return jgraph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)


DEEP = (16, 32, 24, 4)      # two hidden layers: the eq. (5) Z objective
CONFIGS = [(True, True, DIMS), (True, False, DIMS), (False, True, DIMS),
           (False, False, DIMS), (True, True, DEEP)]
IDS = ["packed-kernel", "packed-einsum", "strided-kernel", "strided-einsum",
       "deep-packed-kernel"]


@pytest.fixture(scope="module")
def pairs():
    """(packed, use_kernel, dims) -> (JAX trainer, port trainer) at one
    shared state: the JAX state after WARM steps, copied into the port."""
    cache = {}

    def get(packed, use_kernel, dims):
        if (packed, use_kernel, dims) not in cache:
            g, _ = _case_graph()
            kw = dict(use_kernel=use_kernel)
            jt = JaxTrainer(jgcn.GCNConfig(dims), JaxADMM(nu=NU, rho=RHO), g,
                            8, mesh=make_mesh((1,), (AXIS,)), seed=0,
                            config=(JaxConfig.packed if packed
                                    else JaxConfig.p2p)(**kw))
            for _ in range(WARM):
                jt.step()
            tt = ParallelADMMTrainer(
                gcn.GCNConfig(dims), ADMMConfig(nu=NU, rho=RHO), g, 8,
                seed=0, device="cpu",
                config=(TrainerConfig.packed if packed
                        else TrainerConfig.p2p)(**kw))
            tt.state = state_from_numpy(*_numpy(jt.state), device="cpu")
            cache[(packed, use_kernel, dims)] = (jt, tt)
        return cache[(packed, use_kernel, dims)]
    return get


def _numpy(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def _assert_metrics_match(jt, tt):
    want = [float(x) for x in jt._metrics(jt.state)]
    want.append(float(jt._lagrangian(jt.state)))
    got = [float(x) for x in tt._metrics(tt.state)]
    got.append(float(tt._lagrangian(tt.state)))
    for name, a, b in zip(("train", "test", "residual", "lagrangian"),
                          want, got):
        assert _rel(a, b) <= 1e-5, (name, a, b)


@pytest.mark.parametrize("packed,use_kernel,dims", CONFIGS, ids=IDS)
def test_one_step_from_shared_state_matches_reference(pairs, packed,
                                                      use_kernel, dims):
    jt, tt = pairs(packed, use_kernel, dims)
    start = tt.state
    _assert_metrics_match(jt, tt)
    # the compiled step donates its input: hand it a copy of the state
    s_jax = _numpy(jt._step(jax.tree_util.tree_map(jnp.array, jt.state)))
    s_port = tt.next_state(start)
    assert [float(t) for t in s_port.taus] == [float(t) for t in s_jax.taus]
    for a, b in zip(s_jax.thetas, s_port.thetas):
        np.testing.assert_array_equal(b.numpy(), a)
    for leaf in ("weights", "zs"):
        for a, b in zip(getattr(s_jax, leaf), getattr(s_port, leaf)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s_port.u.numpy(), s_jax.u, rtol=1e-4,
                               atol=1e-5)
    # metrics and Lagrangian after the step, each package on its own result
    saved = jt.state
    jt.state = jax.tree_util.tree_map(jnp.asarray, s_jax)
    tt.state = s_port
    try:
        _assert_metrics_match(jt, tt)
    finally:
        jt.state, tt.state = saved, start


def _jax_objectives(jt, use_kernel):
    """The W-update objectives (values, gradients) and the hidden-layer
    lane objective at the JAX trainer's state, written with jnp from the
    reference's own data and aggregation — the current weights stand in
    for W^{k+1}, as in ``ParallelADMMTrainer.objectives``."""
    d, st = jt.data, jt.state
    if jt.packed:
        dl = jt.packed_layout

        def blk(x):
            return jnp.asarray(dl.unpack_state(np.asarray(x)))
    else:
        def blk(x):
            return jnp.asarray(x)

    def agg(x):
        if use_kernel:
            return jops.community_spmm_ell(d.ell_blocks, d.ell_indices,
                                           d.ell_mask, x, d.row_counts,
                                           d.nbr_counts)
        zg = x[d.ell_indices] * d.ell_mask[..., None, None]
        return jnp.einsum("kdip,kdpc->kic", d.ell_blocks, zg)

    z0 = blk(d.z0)
    z1, z2, u = blk(st.zs[0]), blk(st.zs[1]), blk(st.u)
    w1, w2 = st.weights
    agg0, agg1 = agg(z0), agg(z1)

    def phi0(w):
        r = z1 - jax.nn.relu(agg0 @ w)
        return 0.5 * NU * jnp.vdot(r, r).real

    def phi1(w):
        r = z2 - agg1 @ w
        return jnp.vdot(u, r).real + 0.5 * RHO * jnp.vdot(r, r).real

    idx, wt = d.ell_indices, d.ell_mask[..., None, None]
    target1 = jax.nn.relu(agg0 @ w1)
    q_nbr, last, uv = (agg1 @ w2)[idx], z2[idx], u[idx]

    def psi(z):
        own = jnp.einsum("kdnp,knc->kdpc", d.ell_blocks, (z - z1) @ w2)
        r1 = z - target1
        r2 = (last - (q_nbr + own)) * wt
        return (0.5 * NU * jnp.sum(r1 * r1, axis=(1, 2))
                + jnp.sum(uv * r2, axis=(1, 2, 3))
                + 0.5 * RHO * jnp.sum(r2 * r2, axis=(1, 2, 3)))

    w_out = [jax.value_and_grad(phi0)(w1), jax.value_and_grad(phi1)(w2)]
    z_out = [(psi(z1), jax.grad(lambda z: psi(z).sum())(z1))]
    return w_out, z_out


@pytest.mark.parametrize("packed,use_kernel", [c[:2] for c in CONFIGS[:4]],
                         ids=IDS[:4])
def test_objectives_and_gradients_match_reference(pairs, packed, use_kernel):
    """Branch-free: the values and gradients each line search starts from
    (two-layer net; the jnp mirror below spells out its two objectives)."""
    jt, tt = pairs(packed, use_kernel, DIMS)
    w_want, z_want = _jax_objectives(jt, use_kernel)
    got = tt.objectives()
    for (va, ga), (vb, gb) in zip(w_want + z_want, got["w"] + got["z"]):
        va, ga = np.asarray(va), np.asarray(ga)
        vb, gb = vb.numpy(), gb.numpy()
        assert np.abs(vb - va).max() <= 1e-5 * np.abs(va).max()
        assert np.abs(gb - ga).max() <= 1e-5 * np.abs(ga).max()


@pytest.mark.parametrize("packed,use_kernel,dims", CONFIGS, ids=IDS)
def test_comm_stats_match_reference(pairs, packed, use_kernel, dims):
    """Every ``comm_stats`` key the port computes (those that need no
    exchange plan) equals the reference's."""
    jt, tt = pairs(packed, use_kernel, dims)
    for key, val in tt.comm_stats.items():
        assert jt.comm_stats[key] == val, key


def test_packed_state_is_bitwise_the_strided_state():
    """Packing changes where rows live, never the math: the packed trainer's
    iterates unpack to the strided trainer's bit for bit."""
    g, _ = _case_graph()
    args = (gcn.GCNConfig(DIMS), ADMMConfig(nu=NU, rho=RHO), g, 8)
    strided = ParallelADMMTrainer(*args, config=TrainerConfig.p2p(),
                                  device="cpu")
    packed = ParallelADMMTrainer(*args, config=TrainerConfig.packed(),
                                 device="cpu")
    dl = packed.packed_layout
    for _ in range(2):
        strided.step()
        packed.step()
    for a, b in zip(strided.state.zs + (strided.state.u,),
                    packed.state.zs + (packed.state.u,)):
        assert b.shape[0] == dl.total_rows
        np.testing.assert_array_equal(a.numpy(), dl.unpack_state(b.numpy()))
    for a, b in zip(strided.state.weights, packed.state.weights):
        assert torch.equal(a, b)
    assert float(strided._lagrangian(strided.state)) == \
        float(packed._lagrangian(packed.state))
    for a, b in zip(strided._metrics(strided.state),
                    packed._metrics(packed.state)):
        assert float(a) == float(b)


def test_initial_forward_matches_reference_from_shared_weights():
    """The port's initial Z (forward pass through the dense Ã) from the JAX
    initial weights equals the JAX initial state."""
    g, _ = _case_graph()
    jt = JaxTrainer(jgcn.GCNConfig(DIMS), JaxADMM(nu=NU, rho=RHO), g, 8,
                    mesh=make_mesh((1,), (AXIS,)), seed=0,
                    config=JaxConfig.packed())
    tt = ParallelADMMTrainer(gcn.GCNConfig(DIMS), ADMMConfig(nu=NU, rho=RHO),
                             g, 8, seed=0, config=TrainerConfig.packed(),
                             device="cpu")
    ws = weights_from_numpy(_numpy(jt.state.weights), device="cpu")
    a = torch.as_tensor(jgraph.normalized_adjacency(g.num_nodes, g.edges))
    zs = gcn.forward(tt.cfg, a, torch.as_tensor(g.features), ws)
    for z, want in zip(zs, jt.state.zs):
        np.testing.assert_allclose(tt._to_state(z.numpy()).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)


def test_cli_trains_on_cpu():
    log = train_gcn.main(["--dataset", "amazon_photo_mini", "--parts", "3",
                          "--hidden", "16", "--epochs", "2", "--compressed",
                          "--packed", "--use-kernel", "--partitioner",
                          "bfs_kl", "--device", "cpu"])
    assert len(log["epoch"]) == 2
    assert all(math.isfinite(v) for key in ("lagrangian", "residual",
                                            "train_acc", "test_acc")
               for v in log[key])
