"""The port's one-device Parallel ADMM trainer against the JAX package.

Like with like, from a shared state, over one step: the JAX trainer runs on
a one-device mesh and the port on ``device="cpu"``, each in the same mode —
packed or strided ELL, bf16 ELL blocks, or dense adjacency over the
all-gather; the port's ``use_kernel=False`` (plain einsum) is held against
JAX ``use_kernel=False`` and its ``use_kernel=True`` (on the CPU, the
kernel's plain version) against JAX ``use_kernel=True`` (off a TPU, the jnp
oracle).  The bf16 trainer is held against the JAX bf16 trainer, never
against f32 (the two differ by more than float noise after a few steps).

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
from repro.core import messages as jmessages
from repro.core.parallel import AXIS
from repro.core.parallel import ParallelADMMTrainer as JaxTrainer
from repro.core.parallel import TrainerConfig as JaxConfig
from repro.core.subproblems import ADMMConfig as JaxADMM
from repro.core.subproblems import stale_weights as jax_stale_weights
from repro.kernels import ops as jops
from repro.util.compat import make_mesh
from repro_torch.convert import state_from_numpy, weights_from_numpy
from repro_torch.core import gcn, messages
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
    TrainerConfig.minibatch(), TrainerConfig.packed(comm_bf16=True)],
    ids=["minibatch", "comm_bf16"])
def test_unported_configs_raise_naming_the_roadmap(config):
    """The two configurations that once raised (naming the ROADMAP item
    that would port them) now build on one shard and take a finite step;
    tests/test_torch_multishard.py holds them against the reference."""
    g, _ = _case_graph()
    tt = ParallelADMMTrainer(gcn.GCNConfig(DIMS), ADMMConfig(), g, 8,
                             config=config, device="cpu")
    tt.step()
    st = tt.state
    assert all(bool(torch.isfinite(t).all())
               for t in st.weights + st.zs + (st.u,) + st.taus + st.thetas)
    assert tt.comm_stats["minibatch"]["enabled"] == \
        (config.batch_fraction is not None)


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
# mode -> (preset, extra TrainerConfig fields), the same in both packages
MODES = {"packed": ("packed", {}), "strided": ("p2p", {}),
         "dense": ("dense", {}),
         "packed-bf16": ("packed", {"adjacency_bf16": True}),
         "strided-bf16": ("p2p", {"adjacency_bf16": True})}
CONFIGS = [("packed", True, DIMS), ("packed", False, DIMS),
           ("strided", True, DIMS), ("strided", False, DIMS),
           ("packed", True, DEEP), ("dense", True, DIMS),
           ("dense", False, DIMS), ("dense", True, DEEP),
           ("packed-bf16", True, DIMS), ("strided-bf16", False, DIMS)]
IDS = ["packed-kernel", "packed-einsum", "strided-kernel", "strided-einsum",
       "deep-packed-kernel", "dense-kernel", "dense-einsum",
       "deep-dense-kernel", "packed-bf16-kernel", "strided-bf16-einsum"]
TWO_LAYER = [(c[0], c[1]) for c in CONFIGS if c[2] == DIMS]
TWO_LAYER_IDS = [i for c, i in zip(CONFIGS, IDS) if c[2] == DIMS]


@pytest.fixture(scope="module")
def pairs():
    """(mode, use_kernel, dims) -> (JAX trainer, port trainer) at one
    shared state: the JAX state after WARM steps, copied into the port."""
    cache = {}

    def get(mode, use_kernel, dims):
        if (mode, use_kernel, dims) not in cache:
            g, _ = _case_graph()
            preset, kw = MODES[mode]
            kw = dict(kw, use_kernel=use_kernel)
            jt = JaxTrainer(jgcn.GCNConfig(dims), JaxADMM(nu=NU, rho=RHO), g,
                            8, mesh=make_mesh((1,), (AXIS,)), seed=0,
                            config=getattr(JaxConfig, preset)(**kw))
            for _ in range(WARM):
                jt.step()
            tt = ParallelADMMTrainer(
                gcn.GCNConfig(dims), ADMMConfig(nu=NU, rho=RHO), g, 8,
                seed=0, device="cpu",
                config=getattr(TrainerConfig, preset)(**kw))
            tt.state = state_from_numpy(*_numpy(jt.state), device="cpu")
            cache[(mode, use_kernel, dims)] = (jt, tt)
        return cache[(mode, use_kernel, dims)]
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


@pytest.mark.parametrize("mode,use_kernel,dims", CONFIGS, ids=IDS)
def test_one_step_from_shared_state_matches_reference(pairs, mode,
                                                      use_kernel, dims):
    jt, tt = pairs(mode, use_kernel, dims)
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
    for W^{k+1}, as in ``ParallelADMMTrainer.objectives``.  Dense mode
    aggregates over the block row masked by the neighbour rows and couples
    through every block, weighted by them; ELL mode over the stored
    slots."""
    d, st = jt.data, jt.state
    if jt.packed:
        dl = jt.packed_layout

        def blk(x):
            return jnp.asarray(dl.unpack_state(np.asarray(x)))
    else:
        def blk(x):
            return jnp.asarray(x)

    dense = d.a_blocks is not None
    nbr = d.neighbor_mask.astype(jnp.float32)

    def agg(x):
        if dense and use_kernel:
            return jops.community_spmm(d.a_blocks, x, d.neighbor_mask)
        if dense:
            return jnp.einsum("kmip,mpc->kic",
                              d.a_blocks * nbr[:, :, None, None], x)
        if use_kernel:
            return jops.community_spmm_ell(d.ell_blocks, d.ell_indices,
                                           d.ell_mask, x, d.row_counts,
                                           d.nbr_counts)
        zg = x[d.ell_indices] * d.ell_mask[..., None, None]
        return jnp.einsum("kdip,kdpc->kic",
                          d.ell_blocks.astype(jnp.float32), zg)

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

    if dense:
        rows, spec, wt = d.a_blocks, "kmnp,knc->kmpc", nbr[:, :, None, None]

        def nbr_vals(x):
            return x[None]
    else:
        rows, spec = d.ell_blocks.astype(jnp.float32), "kdnp,knc->kdpc"
        wt = d.ell_mask[..., None, None]

        def nbr_vals(x):
            return x[d.ell_indices]
    target1 = jax.nn.relu(agg0 @ w1)
    q_nbr, last, uv = nbr_vals(agg1 @ w2), nbr_vals(z2), nbr_vals(u)

    def psi(z):
        own = jnp.einsum(spec, rows, (z - z1) @ w2)
        r1 = z - target1
        r2 = (last - (q_nbr + own)) * wt
        return (0.5 * NU * jnp.sum(r1 * r1, axis=(1, 2))
                + jnp.sum(uv * r2, axis=(1, 2, 3))
                + 0.5 * RHO * jnp.sum(r2 * r2, axis=(1, 2, 3)))

    w_out = [jax.value_and_grad(phi0)(w1), jax.value_and_grad(phi1)(w2)]
    z_out = [(psi(z1), jax.grad(lambda z: psi(z).sum())(z1))]
    return w_out, z_out


@pytest.mark.parametrize("mode,use_kernel", TWO_LAYER, ids=TWO_LAYER_IDS)
def test_objectives_and_gradients_match_reference(pairs, mode, use_kernel):
    """Branch-free: the values and gradients each line search starts from
    (two-layer net; the jnp mirror above spells out its two objectives)."""
    jt, tt = pairs(mode, use_kernel, DIMS)
    w_want, z_want = _jax_objectives(jt, use_kernel)
    got = tt.objectives()
    # ∇φ(W_1) is a difference of nearly equal terms (the layer-1 residual
    # is small), so summation-order noise in the aggregate is its largest
    # error: ~5e-9 in every mode, 6.8e-6 of max |∇| on the f32 state.  On
    # the bf16 trainer's state max |∇| is half as large (3.9e-4 against
    # 7.5e-4), so the same noise is 1.2e-5 of it.
    g_tol = 2e-5 if mode.endswith("bf16") else 1e-5
    for (va, ga), (vb, gb) in zip(w_want + z_want, got["w"] + got["z"]):
        va, ga = np.asarray(va), np.asarray(ga)
        vb, gb = vb.numpy(), gb.numpy()
        assert np.abs(vb - va).max() <= 1e-5 * np.abs(va).max()
        assert np.abs(gb - ga).max() <= g_tol * np.abs(ga).max()


@pytest.mark.parametrize("mode,use_kernel,dims", CONFIGS, ids=IDS)
def test_comm_stats_match_reference(pairs, mode, use_kernel, dims):
    """Every ``comm_stats`` key equals the reference's, the exchange plan's
    wire and overlap pricing included; the overlap model is priced on the
    port's device (``messages.PEAK_FLOPS`` / ``LINK_BW``), so it is held
    against the reference's ``overlap_stats`` on the reference's plan at
    those constants.  In dense mode the kernel computes every pad row, so
    ``pad_flops`` is the unguarded count even with ``use_kernel=True``;
    the all-gather's wire is the full payload."""
    jt, tt = pairs(mode, use_kernel, dims)
    assert set(tt.comm_stats) == set(jt.comm_stats)
    for key, val in tt.comm_stats.items():
        if key == "overlap":
            want = _reference_overlap(jt)
            assert val == want
            assert val["model"]["ici_bw"] == messages.LINK_BW
        else:
            assert jt.comm_stats[key] == val, key
    if mode == "dense":
        assert tt.comm_stats["pad_guards"]["kernel"] is False
        assert tt.comm_stats["wire_bytes"] == tt.comm_stats["full_bytes"]
    if mode.endswith("bf16"):
        assert tt.data.ell_blocks.dtype == torch.bfloat16


def _reference_overlap(jt):
    """The reference's overlap pricing of its active plan, at the port's
    device model."""
    got = jt.comm_stats["overlap"]
    dims = list(jt.cfg.layer_dims)
    gathered_cs = [dims[0]] + dims[1:]
    if jt.cfg.num_layers >= 2:
        gathered_cs += dims[2:] + [dims[-1], dims[-2]]
    return jmessages.overlap_stats(
        jt._active_plan, jt.layout.neighbor_mask, gathered_cs,
        itemsize=got["model"]["itemsize"], enabled=got["enabled"],
        peak_flops=messages.PEAK_FLOPS, ici_bw=messages.LINK_BW)


def test_adjacency_bf16_halves_the_resident_blocks():
    """The bf16 ELL store holds the f32 blocks rounded to bf16, as the
    reference's does, in half the bytes; indices and mask are unchanged."""
    g, _ = _case_graph()
    args = (gcn.GCNConfig(DIMS), ADMMConfig(nu=NU, rho=RHO), g, 8)
    f32 = ParallelADMMTrainer(*args, config=TrainerConfig.p2p(),
                              device="cpu")
    b16 = ParallelADMMTrainer(*args, device="cpu",
                              config=TrainerConfig.p2p(adjacency_bf16=True))
    jt = JaxTrainer(jgcn.GCNConfig(DIMS), JaxADMM(nu=NU, rho=RHO), g, 8,
                    mesh=make_mesh((1,), (AXIS,)), seed=0,
                    config=JaxConfig.p2p(adjacency_bf16=True))
    np.testing.assert_array_equal(
        b16.data.ell_blocks.float().numpy(),
        np.asarray(jt.data.ell_blocks.astype(jnp.float32)))
    blocks = f32.data.ell_blocks
    assert b16.data.ell_blocks.nbytes * 2 == blocks.nbytes
    assert f32.data.adjacency_nbytes - b16.data.adjacency_nbytes == \
        blocks.nbytes // 2
    assert b16.data.adjacency_nbytes == \
        jt.comm_stats["adjacency"]["resident_bytes"]


def test_dense_mode_holds_the_block_tensor_only():
    """Dense mode keeps the (M, M, n_pad, n_pad) blocks and no ELL view;
    the plain path's masked copy equals the blocks on a real layout (the
    neighbour mask covers every non-zero block)."""
    g, _ = _case_graph()
    tt = ParallelADMMTrainer(gcn.GCNConfig(DIMS), ADMMConfig(nu=NU, rho=RHO),
                             g, 8, device="cpu", config=TrainerConfig())
    assert not tt.data.compressed and tt.data.ell_blocks is None
    assert tt.transport == "allgather"
    m, n = tt.layout.num_parts, tt.layout.n_pad
    assert tuple(tt.data.a_blocks.shape) == (m, m, n, n)
    assert torch.equal(tt._body.a_masked, tt.data.a_blocks)
    np.testing.assert_array_equal(tt.data.a_blocks.numpy(),
                                  tt.layout.a_blocks)


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


def test_cli_trains_on_cpu(capsys):
    log = train_gcn.main(["--dataset", "amazon_photo_mini", "--parts", "3",
                          "--hidden", "16", "--epochs", "2", "--compressed",
                          "--packed", "--use-kernel", "--partitioner",
                          "bfs_kl", "--device", "cpu"])
    assert len(log["epoch"]) == 2
    assert all(math.isfinite(v) for key in ("lagrangian", "residual",
                                            "train_acc", "test_acc")
               for v in log[key])
    assert "adjacency on device [compressed (ELL)]" in capsys.readouterr().out


@pytest.mark.parametrize("flags,adjacency", [
    (["--use-kernel"], "dense"),
    ([], "dense"),
    (["--compressed", "--adjacency-bf16", "--transport", "allgather"],
     "compressed (ELL, bf16 blocks)")],
    ids=["dense-kernel", "dense-einsum", "ell-bf16-allgather"])
def test_cli_dense_and_bf16_modes_train_on_cpu(capsys, flags, adjacency):
    log = train_gcn.main(["--dataset", "amazon_photo_mini", "--parts", "3",
                          "--hidden", "16", "--epochs", "2",
                          "--partitioner", "bfs_kl", "--device", "cpu"]
                         + flags)
    assert len(log["epoch"]) == 2
    assert all(math.isfinite(v) for key in ("lagrangian", "residual",
                                            "train_acc", "test_acc")
               for v in log[key])
    out = capsys.readouterr().out
    assert f"adjacency on device [{adjacency}]" in out
