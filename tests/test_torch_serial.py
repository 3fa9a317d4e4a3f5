"""The port's serial ADMM trainer, backprop baselines and optimizers against
the JAX package.

Like with like, from a shared state: the JAX ``SerialADMMTrainer`` and the
port's on ``device="cpu"``.  The serial Z step line-searches one global θ
per layer, and at the initial state every residual is float noise, so the
first steps of the two packages may accept different τ/θ (they do at 0–2
warm-up steps on the small case below).  The shared state is the JAX state
after ``WARM`` = 5 steps, where τ and θ agree from 3 to 8 warm-up steps for
both the two- and three-layer nets; τ/θ must then be equal and the iterates
agree within rtol 1e-4 / atol 1e-5 (reassociated f32 sums).  The baselines
and optimizers run from shared weights and gradients made with numpy.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gcn as jgcn
from repro.core import graph as jgraph
from repro.core import subproblems as jsub
from repro.core.serial import BaselineTrainer as JaxBaseline
from repro.core.serial import SerialADMMTrainer as JaxSerial
from repro.optim import optimizers as joptim
from repro_torch.convert import serial_state_from_numpy, weights_from_numpy
from repro_torch.core import gcn, subproblems
from repro_torch.core.serial import BaselineTrainer, SerialADMMTrainer
from repro_torch.optim import optimizers

WARM = 5
DIMS = (16, 32, 4)
DEEP = (16, 32, 24, 4)       # two hidden layers: the eq. (5) ψ
NU = RHO = 1e-3
OPTIMIZERS = ["gd", "momentum", "adam", "adagrad", "adadelta"]


def _case_graph():
    g, _ = jgraph.synthetic_powerlaw_communities(
        8, nodes_per_part=16, size_skew=1.0, feat_dim=16, seed=0)
    return g


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


@pytest.fixture(scope="module")
def pairs():
    """dims -> (JAX serial trainer, port serial trainer) at one shared
    state: the JAX state after WARM steps, copied into the port."""
    cache = {}

    def get(dims):
        if dims not in cache:
            g = _case_graph()
            jt = JaxSerial(jgcn.GCNConfig(dims), jsub.ADMMConfig(nu=NU,
                                                                 rho=RHO),
                           g, seed=0)
            for _ in range(WARM):
                jt.step()
            tt = SerialADMMTrainer(gcn.GCNConfig(dims),
                                   subproblems.ADMMConfig(nu=NU, rho=RHO), g,
                                   seed=0, device="cpu")
            tt.state = serial_state_from_numpy(*_numpy(jt.state),
                                               device="cpu")
            cache[dims] = (jt, tt)
        return cache[dims]
    return get


def _jax_next(jt):
    return _numpy(jt._step(jt.a_tilde, jt.z0, jt.labels, jt.train_mask,
                           jt.state))


@pytest.mark.parametrize("dims", [DIMS, DEEP], ids=["two-layer", "deep"])
def test_one_serial_step_from_shared_state_matches_reference(pairs, dims):
    jt, tt = pairs(dims)
    want = _jax_next(jt)
    got = tt.next_state()
    assert [float(t) for t in got.taus] == [float(t) for t in want.taus]
    assert [float(t) for t in got.thetas] == [float(t) for t in want.thetas]
    for leaf in ("weights", "zs"):
        for a, b in zip(getattr(want, leaf), getattr(got, leaf)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.u.numpy(), want.u, rtol=1e-4, atol=1e-5)


def _assert_metrics_match(jt, tt, j_state, t_state):
    want = [float(x) for x in jt._metrics(j_state)]
    want.append(float(jt._lagr(jt.a_tilde, jt.z0, jt.labels, jt.train_mask,
                               j_state)))
    got = [float(x) for x in tt._metrics(t_state)]
    got.append(float(tt._lagrangian(t_state)))
    for name, a, b in zip(("train", "test", "residual", "lagrangian"),
                          want, got):
        assert _rel(a, b) <= 1e-5, (name, a, b)


@pytest.mark.parametrize("dims", [DIMS, DEEP], ids=["two-layer", "deep"])
def test_lagrangian_and_metrics_match_reference(pairs, dims):
    """At the shared state and after one step, each package on its own
    result."""
    jt, tt = pairs(dims)
    _assert_metrics_match(jt, tt, jt.state, tt.state)
    want = jax.tree_util.tree_map(jnp.asarray, _jax_next(jt))
    _assert_metrics_match(jt, tt, want, tt.next_state())


@pytest.mark.parametrize("dims", [DIMS, DEEP], ids=["two-layer", "deep"])
def test_phi_and_psi_match_reference(pairs, dims):
    """Branch-free: every W objective and Z objective of the global form,
    and its gradient, near the shared state.  Each is evaluated at its
    variable plus numpy noise of 0.05 rms: at the state itself the hidden
    residuals are float noise (φ(W_1) ~ 7e-9 on the deep net), so a
    relative comparison there would measure summation order, not the
    function."""
    jt, tt = pairs(dims)
    rng = np.random.default_rng(3)

    def near(x):
        x = np.asarray(x)
        x = (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)
        return jnp.asarray(x), torch.as_tensor(x)
    admm_j, admm_t = jt.admm, tt.admm
    js, ts = jt.state, tt.state
    n_l = len(dims) - 1
    for l in range(n_l):
        zp_j = jt.z0 if l == 0 else js.zs[l - 1]
        zp_t = tt.z0 if l == 0 else ts.zs[l - 1]
        if l < n_l - 1:
            def fj(w):
                return jsub.phi_hidden(admm_j, jax.nn.relu, jt.a_tilde, w,
                                       zp_j, js.zs[l])

            def ft(w):
                return subproblems.phi_hidden(admm_t, torch.relu, tt.a_tilde,
                                              w, zp_t, ts.zs[l])
        else:
            def fj(w):
                return jsub.phi_last(admm_j, jt.a_tilde, w, zp_j, js.zs[l],
                                     js.u)

            def ft(w):
                return subproblems.phi_last(admm_t, tt.a_tilde, w, zp_t,
                                            ts.zs[l], ts.u)
        wj, wt = near(js.weights[l])
        _assert_value_and_grad(jax.value_and_grad(fj)(wj),
                               subproblems.value_and_grad(ft, wt))
    for l in range(1, n_l):
        pj = jsub.make_psi(jt.cfg, admm_j, jt.a_tilde, jt.z0, js.weights,
                           js.zs, js.u, l)
        pt = subproblems.make_psi(tt.cfg, admm_t, tt.a_tilde, tt.z0,
                                  ts.weights, ts.zs, ts.u, l)
        zj, zt = near(js.zs[l - 1])
        _assert_value_and_grad(jax.value_and_grad(pj)(zj),
                               subproblems.value_and_grad(pt, zt))


def _assert_value_and_grad(want, got):
    (va, ga), (vb, gb) = want, got
    assert _rel(float(va), float(vb)) <= 1e-5
    ga, gb = np.asarray(ga), gb.numpy()
    assert np.abs(gb - ga).max() <= 1e-5 * np.abs(ga).max()


def test_fista_last_z_matches_reference(pairs):
    """Eq. (7) by FISTA from the shared state's centre B = ÃZ_{L-1}W_L."""
    jt, tt = pairs(DIMS)
    js, ts = jt.state, tt.state
    b_j = jt.a_tilde @ js.zs[0] @ js.weights[1]
    want = jsub.fista_last_z(jt.admm, b_j, js.u, jt.labels, jt.train_mask,
                             js.zs[1])
    b_t = tt.a_tilde @ ts.zs[0] @ ts.weights[1]
    got = subproblems.fista_last_z(tt.admm, b_t, ts.u, tt.labels,
                                   tt.train_mask, ts.zs[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_init_state_matches_reference_from_shared_weights():
    """The initial Z (forward pass) and the scalar τ/θ from the JAX initial
    weights equal the JAX initial state."""
    g = _case_graph()
    jt = JaxSerial(jgcn.GCNConfig(DEEP), jsub.ADMMConfig(), g, seed=0)
    tt = SerialADMMTrainer(gcn.GCNConfig(DEEP), subproblems.ADMMConfig(), g,
                           seed=0, device="cpu")
    ws = weights_from_numpy(_numpy(jt.state.weights), device="cpu")
    zs = gcn.forward(tt.cfg, tt.a_tilde, tt.z0, ws)
    for z, want in zip(zs, jt.state.zs):
        np.testing.assert_allclose(z.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    st = tt.state
    assert len(st.weights) == len(st.zs) == len(st.taus) == len(st.thetas)
    assert all(t.dim() == 0 and float(t) == 1.0 for t in st.taus + st.thetas)
    assert not st.u.any() and st.u.shape == st.zs[-1].shape
    for w, want in zip(st.weights, jt.state.weights):
        assert w.shape == want.shape and w.dtype == torch.float32


def test_serial_trainer_trains_on_cpu():
    g = _case_graph()
    tt = SerialADMMTrainer(gcn.GCNConfig(DIMS),
                           subproblems.ADMMConfig(nu=NU, rho=RHO), g,
                           device="cpu")
    log = tt.train(3, log_every=2)
    assert log.epoch == [0, 2]
    assert all(math.isfinite(v) for key in ("lagrangian", "residual",
                                            "train_acc", "test_acc")
               for v in log.as_dict()[key])


# ---------------------------------------------------------------------------
# baselines and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", OPTIMIZERS)
def test_baseline_steps_match_reference(name):
    """Three backprop steps from shared weights: losses and weights."""
    g = _case_graph()
    jb = JaxBaseline(jgcn.GCNConfig(DIMS), g, name, 1e-2, seed=0)
    tb = BaselineTrainer(gcn.GCNConfig(DIMS), g, name, 1e-2, seed=0,
                         device="cpu")
    tb.weights = weights_from_numpy(_numpy(jb.weights), device="cpu")
    for _ in range(3):
        jb.weights, jb.opt_state, want = jb._step(jb.weights, jb.opt_state)
        tb.weights, tb.opt_state, got = tb._step(tb.weights, tb.opt_state)
        assert _rel(float(want), float(got)) <= 1e-5
    for a, b in zip(jb.weights, tb.weights):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(jb._metrics(jb.weights), tb._metrics(tb.weights)):
        assert _rel(float(a), float(b)) <= 1e-6     # hits / count, 1 ulp


def test_baseline_trains_on_cpu():
    g = _case_graph()
    tb = BaselineTrainer(gcn.GCNConfig(DIMS), g, "adam", 1e-2, device="cpu")
    log = tb.train(3)
    assert log.residual == [0.0] * 3
    assert log.lagrangian[-1] < log.lagrangian[0]
    assert all(math.isfinite(v) for v in log.train_acc + log.test_acc)


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", OPTIMIZERS + ["adamw"])
def test_optimizer_update_rule_matches_reference(name):
    """Four updates on numpy gradients: every delta and every state leaf
    (moments, accumulators, step count) against the reference's."""
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jo, to = joptim.make(name, 3e-2), optimizers.make(name, 3e-2)
    jp = [jnp.asarray(p) for p in params]
    tp = tuple(torch.as_tensor(p) for p in params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(4):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jd, js = jo.update([jnp.asarray(x) for x in grads], js, jp)
        td, ts = to.update(tuple(torch.as_tensor(x) for x in grads), ts, tp)
        for a, b in zip(_flat(jd), td):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-7)
        jp = [p + d for p, d in zip(jp, jd)]
        tp = tuple(p + d for p, d in zip(tp, td))
    want = _flat(js)
    got = [x.numpy() for x in jax.tree_util.tree_leaves(
        ts, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


def test_optimizer_registry_matches_reference():
    assert set(optimizers._REGISTRY) == set(joptim._REGISTRY)
    with pytest.raises(KeyError, match="unknown optimizer"):
        optimizers.make("lion", 1e-3)
    assert dataclasses.asdict(subproblems.ADMMConfig()) == \
        dataclasses.asdict(jsub.ADMMConfig())
