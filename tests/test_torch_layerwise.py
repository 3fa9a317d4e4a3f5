"""The port's layerwise ADMM on transformer stacks (``core/layerwise.py``)
against the JAX package's, at the reduced configurations (f32).

- ``lane_backtracking_tree`` on a small tree: θ equal, step within 1e-6
  relative of max;
- ``init`` from the reference's parameters: Z within 1e-5 · max, and the
  init residual below 1e-4 (tests/test_layerwise.py's constraint test);
- one ``iteration`` from the reference's state after n iterations (carried
  across by ``convert.layerwise_state_from_numpy``): every τ, θ and τ_R
  equal; stack, readout, Z and U within 1e-4 · max per leaf; ``metrics``
  within 1e-5 relative.  The line searches branch on objective differences
  of ``backtrack_rtol`` (1e-6 relative), while the objective, a sum of
  squared residuals Z − F(Z_prev) of ~1e-2 relative, carries ~1e-5
  relative rounding noise between two implementations.  At every depth
  0–9 some probe of the iteration sits within 4e-7 relative of its bound,
  and the reference flips against itself there: on mamba2-1.3b from the
  state after 2 iterations its eager form accepts τ = 2^19 for block 0 at
  a margin of −8.8e-7, its jitted form 2^20.  So each architecture shares
  the state after a depth at which no search of the compared iteration
  flips (gemma-2b 2, qwen2-7b 5; mamba2-1.3b 5 and deepseek-moe-16b 4 in
  tests/test_torch_layerwise_families.py), as tests/test_torch_parallel.py
  does for the GCN trainer;
- the reference's CE-drop tests (tests/test_layerwise.py) held on the port
  alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import layerwise as jlayerwise
from repro.core.subproblems import ADMMConfig as JADMMConfig
from repro_torch.configs import get_config
from repro_torch.convert import (layerwise_state_from_numpy,
                                 model_params_from_numpy)
from repro_torch.core import layerwise
from repro_torch.core.subproblems import ADMMConfig
from repro_torch.util import tree

STATE_TOL = 1e-4
METRIC_TOL = 1e-5
NU = RHO = 1e-2


def lw_batch(cfg, b=4, s=32, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "targets")}


def _close(got, want, tol):
    for w, g in zip(jax.tree.leaves(want), tree.leaves(got)):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= tol * float(np.abs(w).max()), \
            (float(np.abs(g - w).max()), float(np.abs(w).max()))


def check_one_iteration(arch: str, n_before: int) -> None:
    """One iteration of each package from the reference's state after
    ``n_before`` iterations."""
    jtr = jlayerwise.LayerwiseADMMTrainer(jget_config(arch, reduced=True),
                                          JADMMConfig(nu=NU, rho=RHO))
    batch = lw_batch(jtr.cfg)
    targets = jnp.asarray(batch["targets"])
    st, z0 = jtr.init(jax.random.key(0),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    it = jax.jit(lambda s: jtr.iteration(s, z0, targets))
    for _ in range(n_before):
        st = it(st)
    want = it(st)
    want_m = jtr.metrics(want, z0, targets)

    ttr = layerwise.LayerwiseADMMTrainer(get_config(arch, reduced=True),
                                         ADMMConfig(nu=NU, rho=RHO))
    ts, tz0 = layerwise_state_from_numpy(jax.tree.map(np.asarray, st),
                                         np.asarray(z0), "cpu")
    got = ttr.iteration(ts, tz0, batch["targets"])
    for f in ("taus", "thetas", "tau_r"):
        for w, g in zip(jax.tree.leaves(getattr(want, f)),
                        tree.leaves(getattr(got, f))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f)
    for f in ("stack", "readout", "zs", "u"):
        _close(getattr(got, f), getattr(want, f), STATE_TOL)
    for g, w in zip(ttr.metrics(got, tz0, batch["targets"]), want_m):
        assert abs(float(g) - float(w)) <= METRIC_TOL * abs(float(w))


@pytest.mark.parametrize("arch,n_before", [("gemma-2b", 2), ("qwen2-7b", 5)])
def test_iteration_matches_reference(arch, n_before):
    check_one_iteration(arch, n_before)


def _lane_obj(x, target, weight, ops):
    """Per-lane objective of three lanes: a weighted quadratic on one leaf
    and log(1 + b²) on the other."""
    sq = ops.sum(weight * (x["a"] - target) ** 2, axis=(1, 2))
    return 0.5 * sq + ops.sum(ops.log(1.0 + x["b"] ** 2), axis=1)


class _TorchOps:
    log = staticmethod(torch.log)

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)


def test_lane_backtracking_tree_matches_reference():
    rng = np.random.default_rng(3)
    x = {"a": rng.normal(size=(3, 4, 5)).astype(np.float32),
         "b": rng.normal(size=(3, 6)).astype(np.float32)}
    target = rng.normal(size=(3, 4, 5)).astype(np.float32)
    weight = np.array([1.0, 40.0, 900.0], np.float32)[:, None, None]
    theta0 = np.array([1.0, 1.0, 64.0], np.float32)
    admm = ADMMConfig()
    j_step, j_theta = jlayerwise.lane_backtracking_tree(
        lambda t: _lane_obj(t, target, weight, jnp),
        jax.tree.map(jnp.asarray, x), jnp.asarray(theta0),
        JADMMConfig())
    tt = torch.as_tensor
    t_step, t_theta = layerwise.lane_backtracking_tree(
        lambda t: _lane_obj(t, tt(target), tt(weight), _TorchOps),
        tree.tree_map(tt, x), tt(theta0), admm)
    np.testing.assert_array_equal(t_theta.numpy(), np.asarray(j_theta))
    assert len(set(t_theta.tolist())) > 1       # lanes accept independently
    _close(t_step, j_step, 1e-6)


def test_init_from_shared_parameters(monkeypatch):
    arch = "gemma-2b"
    jtr = jlayerwise.LayerwiseADMMTrainer(jget_config(arch, reduced=True),
                                          JADMMConfig())
    batch = lw_batch(jtr.cfg)
    key = jax.random.key(0)
    jst, jz0 = jtr.init(key, {k: jnp.asarray(v) for k, v in batch.items()})
    params = model_params_from_numpy(
        jax.tree.map(np.asarray, jtr.model.init(key)), "cpu")
    ttr = layerwise.LayerwiseADMMTrainer(get_config(arch, reduced=True),
                                         ADMMConfig())
    monkeypatch.setattr(ttr.model, "init", lambda seed, device: params)
    tst, tz0 = ttr.init(0, batch, "cpu")
    np.testing.assert_array_equal(tz0.numpy(), np.asarray(jz0))
    _close(tst.zs, jst.zs, 1e-5)
    for f in ("taus", "thetas", "tau_r", "u"):
        for w, g in zip(jax.tree.leaves(getattr(jst, f)),
                        tree.leaves(getattr(tst, f))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, res = ttr.metrics(tst, tz0, batch["targets"])
    assert float(res) < 1e-4


def test_port_init_satisfies_constraints():
    """Z from the port's own forward pass: residual ~0."""
    tr = layerwise.LayerwiseADMMTrainer(get_config("gemma-2b", reduced=True),
                                        ADMMConfig())
    batch = lw_batch(tr.cfg)
    state, z0 = tr.init(0, batch, "cpu")
    _, res = tr.metrics(state, z0, batch["targets"])
    assert float(res) < 1e-4


@pytest.mark.parametrize("arch,iters,ratio", [
    ("qwen2-7b", 6, 0.7), ("gemma-2b", 6, 0.7), ("mamba2-1.3b", 6, 0.7),
    ("deepseek-moe-16b", 5, 1.0)])
def test_layerwise_admm_decreases_ce(arch, iters, ratio):
    """tests/test_layerwise.py's CE-drop tests on the port alone: CE below
    0.7 of its initial value after 6 iterations (the MoE model: below it
    after 5), the residual finite; every search counted."""
    tr = layerwise.LayerwiseADMMTrainer(get_config(arch, reduced=True),
                                        ADMMConfig(nu=NU, rho=RHO))
    batch = lw_batch(tr.cfg)
    state, z0 = tr.init(0, batch, "cpu")
    ce0, _ = tr.metrics(state, z0, batch["targets"])
    searches = layerwise.searches
    for _ in range(iters):
        state = tr.iteration(state, z0, batch["targets"])
    ce, res = tr.metrics(state, z0, batch["targets"])
    assert float(ce) < ratio * float(ce0), (arch, float(ce0), float(ce))
    assert np.isfinite(float(res))
    assert layerwise.searches - searches == iters * (
        2 * len(tr.segments) + 1)


def _mesh_rank(model_rank: int, n_model: int):
    """Rank ``model_rank`` of a 1 × ``n_model`` mesh, as the trainer's
    placement sees it (no group is joined: placing blocks communicates
    nothing)."""
    from repro_torch.launch.mesh import AxisGroup, ProcessMesh
    cpu = torch.device("cpu")
    return ProcessMesh(
        model_rank, n_model, "gloo", cpu, None, ("data", "model"),
        (1, n_model), {("data",): AxisGroup(0, 1, "gloo", cpu, None,
                                            (model_rank,)),
                       ("model",): AxisGroup(model_rank, n_model, "gloo",
                                             cpu, None,
                                             tuple(range(n_model)))})


def test_mesh_is_refused():
    """A mesh places the network's blocks, segment after segment, in
    near-equal contiguous ranges over ``model`` (gemma-2b's 18 go 9 / 9,
    deepseek-moe-16b's 1 + 27 go 14 / 14 with the segment boundary inside
    the first range); a mesh with more model ranks than blocks is refused.
    (One iteration over 4 gloo ranks against the reference:
    tests/test_torch_mesh_layerwise.py.)"""
    def local(arch, rank, n_model, reduced=False):
        tr = layerwise.LayerwiseADMMTrainer(
            get_config(arch, reduced=reduced), ADMMConfig(),
            mesh=_mesh_rank(rank, n_model))
        return [(s.kind, lo, hi) for s, lo, hi, _ in tr.local]
    assert local("gemma-2b", 0, 2) == [("attn_mlp", 0, 9)]
    assert local("gemma-2b", 1, 2) == [("attn_mlp", 9, 18)]
    assert local("deepseek-moe-16b", 0, 2) == [("attn_mlp", 0, 1),
                                               ("attn_moe", 0, 13)]
    assert local("deepseek-moe-16b", 1, 2) == [("attn_moe", 13, 27)]
    assert [local("qwen2-7b", r, 3) for r in range(3)] == [
        [("attn_mlp", 0, 10)], [("attn_mlp", 10, 19)],
        [("attn_mlp", 19, 28)]]
    with pytest.raises(ValueError, match="2 blocks cannot cover 4"):
        local("gemma-2b", 0, 4, reduced=True)
