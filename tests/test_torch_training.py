"""Language-model training of the port against the JAX package, at the
reduced configurations (f32): schedules, the optimizers over parameter
trees, a whole first Adam step, remat, the deferred-reduction step, the
token pipeline, the one-device mesh and the training launcher.

Tolerances, each beside its test:
- schedules: ``constant`` and ``warmup`` bitwise equal for steps 0–200;
  ``cosine`` the same function of a cos one f32 spacing apart:
  ``torch.cos`` and the reference's cos (XLA's CPU backend calls the C
  library's ``cosf``) round the last bit differently at some arguments (8
  of the 201 steps), and the value is 0.1 + 0.45 · (1 + cos), so within
  0.45 · 2^-24 (one spacing of |cos| < 1, scaled) plus one spacing of the
  value;
- the optimizers fed the same gradients: deltas and state within 1e-6
  relative of max per leaf, ``t`` equal; the state is updated in place;
- a whole first Adam step: Adam's first delta is ≈ −lr · sign(g), which
  flips where |g| sits at f32 noise, so every element within 2 · lr, and
  at most 1e-4 of the elements apart by more than 1e-3 · lr (measured:
  11 of 1,246,464, 8.8e-6, at most 8.9e-5 = 0.30 · lr);
- remat on and off: gradients within 1e-6 · max per leaf;
- ``train_step_deferred`` against the reference's on a (1, 1) host mesh:
  as ``train_step`` (tests/test_torch_train_step.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import synthetic_token_batches as jtokens
from repro.models.build import make_model as jmake_model
from repro.optim import optimizers as joptim
from repro.optim import schedules as jsched
from repro_torch import checkpoint, configs
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.data import TokenPipeline, synthetic_token_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer
from repro_torch.models.build import make_model
from repro_torch.optim import optimizers, schedules
from repro_torch.util import tree
from test_torch_train_step import (assert_metrics_close, assert_steps_close,
                                   sgd_pair, train_batch)

OPT_TOL = 1e-6
COS_SLACK = 0.45 * 2.0 ** -24      # one spacing of cos, through 0.45 · cos
REMAT_TOL = 1e-6


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["constant", "warmup", "cosine"])
@pytest.mark.parametrize("tensor_step", [False, True])
def test_schedules_equal_reference(name, tensor_step):
    ref, port = jsched.make(name, 150, 20), schedules.make(name, 150, 20)
    for step in range(201):
        want = np.float32(ref(jnp.int32(step) if tensor_step else step))
        got = port(torch.tensor(step, dtype=torch.int32) if tensor_step
                   else step)
        assert got.dtype == torch.float32 and got.dim() == 0
        got = np.float32(got.item())
        if name == "cosine":
            assert abs(got - want) <= COS_SLACK + np.spacing(want), \
                (step, got, want)
        else:
            assert got == want, (step, got, want)
    with pytest.raises(KeyError):
        schedules.make("linear", 10)


def test_scale_updates_equals_reference():
    rng = np.random.default_rng(0)
    ups = {"a": rng.normal(size=(3, 4)).astype(np.float32),
           "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    scale = np.float32(0.37)
    want = jsched.scale_updates(jax.tree.map(jnp.asarray, ups),
                                jnp.asarray(scale))
    got = schedules.scale_updates(
        tree.tree_map(torch.as_tensor, ups), torch.tensor(scale))
    for w, g in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    bf = schedules.scale_updates({"x": torch.ones(2, dtype=torch.bfloat16)},
                                 torch.tensor(0.5))
    assert bf["x"].dtype == torch.bfloat16


# --------------------------------------------------------------- optimizers

def _param_tree(rng):
    return {"stack": {"w": rng.normal(size=(2, 6, 5)).astype(np.float32),
                      "b": rng.normal(size=(2, 5)).astype(np.float32)},
            "embedding": {"table": rng.normal(size=(7, 6))
                          .astype(np.float32)},
            "final_norm": {"scale": np.ones((6,), np.float32)}}


def _close_tree(got, want, tol=OPT_TOL):
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree.leaves_with_paths(got)
    assert [tree.path_str(p) for p, _ in got_leaves] == \
        ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
         for p, _ in want_leaves]
    for (_, w), (_, g) in zip(want_leaves, got_leaves):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


@pytest.mark.parametrize("name", sorted(optimizers._REGISTRY))
def test_tree_optimizers_match_reference(name):
    """Three updates with the same gradients on a nested-dict tree: the
    state has the reference's structure and key paths (Adam {m, v, t},
    SGD ()); deltas and state within 1e-6 relative; the state's tensors
    are written in place."""
    rng = np.random.default_rng(1)
    params = _param_tree(rng)
    jo, to = joptim.make(name, 3e-2), optimizers.make(name, 3e-2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree.tree_map(torch.as_tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    _close_tree(ts, js)
    for _ in range(3):
        grads = tree.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        jd, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        before = [t.data_ptr() for t in tree.leaves(ts)
                  if t.dim() > 0]
        td, ts = to.update(tree.tree_map(torch.as_tensor, grads), ts, tp)
        _close_tree(td, jd)
        _close_tree(ts, js)
        assert before == [t.data_ptr() for t in tree.leaves(ts)
                          if t.dim() > 0]
    if name == "adam":
        assert int(ts["t"]) == int(js["t"]) == 3
    if name in ("sgd", "gd"):
        assert ts == () and js == ()


def test_adam_casts_deltas_to_bf16_params():
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    g = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    jp = {"w": jnp.asarray(p["w"]).astype(jnp.bfloat16)}
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jo, to = joptim.adam(1e-2), optimizers.adam(1e-2)
    jd, js = jo.update({"w": jnp.asarray(g["w"]).astype(jnp.bfloat16)},
                       jo.init(jp), jp)
    td, ts = to.update(model_params_from_numpy(
        {"w": np.asarray(jnp.asarray(g["w"]).astype(jnp.bfloat16))}, "cpu"),
        to.init(tp), tp)
    assert td["w"].dtype == torch.bfloat16 and ts["m"]["w"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        np.asarray(jd["w"]).astype(np.float32), td["w"].float().numpy())


def test_first_adam_step_matches_reference():
    """A whole first train_step with the config's Adam (lr 3e-4) from the
    same parameters and state (the reference's state carried across by
    ``opt_state_from_numpy``)."""
    jcfg = jconfigs.get_config("gemma-2b", reduced=True)
    jm, tm = jmake_model(jcfg), make_model(
        configs.get_config("gemma-2b", reduced=True))
    jp = jm.init(jax.random.key(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js = jm.init_optimizer().init(jp)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    batch = train_batch(jcfg)
    j_new, j_st, j_met = jax.jit(jm.train_step)(jp, js, batch)
    t_new, t_st, t_met = tm.train_step(tp, ts, batch)
    assert_metrics_close(t_met, j_met)
    assert int(t_st["t"]) == int(j_st["t"]) == 1
    lr = jcfg.learning_rate
    apart = total = 0
    for w, g in zip(jax.tree.leaves(j_new), tree.leaves(t_new)):
        d = np.abs(np.asarray(w) - g.numpy())
        assert float(d.max()) <= 2 * lr
        apart += int((d > 1e-3 * lr).sum())
        total += d.size
    assert apart <= 1e-4 * total, (apart, total)


# -------------------------------------------------------------------- remat

def _grads(model, params, batch):
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = model.loss(tree.unflatten(params, live),
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    return torch.autograd.grad(loss, live, allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("arch", ["gemma-2b", "seamless-m4t-medium"])
def test_remat_gradients_equal_plain(arch, monkeypatch):
    """Every layer (the encoder's too) runs under torch.utils.checkpoint
    when cfg.remat and gradients are on, and never without gradients."""
    calls = []
    real = transformer.checkpoint

    def counted(*args, **kw):
        calls.append(args[1])
        return real(*args, **kw)
    monkeypatch.setattr(transformer, "checkpoint", counted)
    cfg = configs.get_config(arch, reduced=True)
    on, off = (make_model(dataclasses.replace(cfg, remat=r))
               for r in (True, False))
    params = on.init(seed=0, device="cpu")
    batch = train_batch(cfg)
    g_on = _grads(on, params, batch)
    n_layers = sum(s.count for s in transformer.arch_segments(cfg))
    assert len(calls) == n_layers
    g_off = _grads(off, params, batch)
    assert len(calls) == n_layers
    for a, b in zip(g_on, g_off):
        assert float((a - b).abs().max()) <= REMAT_TOL * float(
            b.abs().max())
    with torch.no_grad():
        on.forward(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert len(calls) == n_layers


# ------------------------------------------------------------ deferred step

@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_train_step_deferred_matches_reference(arch):
    jm, tm, jp, tp = sgd_pair(arch, grad_accum=2)
    batch = train_batch(jm.cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        j_new, _, j_met = jax.jit(functools.partial(
            jm.train_step_deferred, mesh))(jp, (), batch)
    t_new, _, t_met = tm.train_step_deferred(
        mesh_lib.make_host_mesh("cpu"), tp, (), batch)
    assert_steps_close(jp, t_new, j_new)
    assert_metrics_close(t_met, j_met)


# ----------------------------------------------------- pipeline and launcher

def test_pipeline_gives_the_reference_batches():
    port = TokenPipeline(synthetic_token_batches(512, 3, 40, seed=4),
                         device="cpu")
    ref = JTokenPipeline(jtokens(512, 3, 40, seed=4))
    for i in range(5):
        got, want = next(port), next(ref)
        assert len(port._buf) == port.prefetch - 1
        for k in ("tokens", "targets"):
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_host_mesh_is_one_device(monkeypatch):
    """The one-device mesh; the production mesh refuses any world but its
    256 (multi-pod 512) ranks, naming the size, before joining a group."""
    mesh = mesh_lib.make_host_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh_lib.data_axes(mesh) == ("data",)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="256 ranks; this world has 1"):
        mesh_lib.make_production_mesh()
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="256 ranks; this world has 4"):
        mesh_lib.make_production_mesh()
    monkeypatch.setenv("WORLD_SIZE", "256")
    with pytest.raises(ValueError, match="2 x 16 x 16 needs a world of 512"):
        mesh_lib.make_production_mesh(multi_pod=True)


def test_launcher_trains_and_checkpoints(tmp_path, capsys):
    run = train_launcher.main([
        "--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "[train] arch=gemma-2b-reduced" in out
    assert "mesh={'data': 1, 'model': 1}" in out
    assert "[train] checkpoint ->" in out
    assert len(run["losses"]) == 3 and all(np.isfinite(run["losses"]))
    assert checkpoint.latest_step(tmp_path) == 2
    state = {"params": run["params"], "opt": run["opt_state"]}
    back = checkpoint.restore(tmp_path, state)
    for a, b in zip(tree.leaves(back), tree.leaves(state)):
        assert torch.equal(a, b)
    # the checkpoint's key paths are the reference's for the same model
    jm = jmake_model(jconfigs.get_config("gemma-2b", reduced=True))
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    jstate = {"params": jp, "opt": jax.eval_shape(jm.init_optimizer().init,
                                                  jp)}
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert [tree.path_str(p) for p, _ in tree.leaves_with_paths(state)] == \
        want


def test_launcher_refuses_what_the_port_does_not_run(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="256 ranks; this world has 1"):
        train_launcher.main(["--arch", "gemma-2b", "--reduced",
                             "--production-mesh", "--steps", "1"])
    with pytest.raises(SystemExit, match="multimodal"):
        train_launcher.main(["--arch", "internvl2-2b", "--reduced",
                             "--device", "cpu", "--steps", "1"])


def test_training_entry_points_without_device_raise_when_cuda_is_absent():
    """The pipeline, the launcher's mesh and the layerwise trainer default
    to the card and refuse to carry on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    from repro_torch.core.layerwise import LayerwiseADMMTrainer
    from repro_torch.core.subproblems import ADMMConfig
    cfg = configs.get_config("gemma-2b", reduced=True)
    for call in (lambda: TokenPipeline(iter(())),
                 mesh_lib.make_host_mesh,
                 lambda: LayerwiseADMMTrainer(cfg, ADMMConfig()).init(
                     0, train_batch(cfg)),
                 lambda: train_launcher.main(["--arch", "gemma-2b",
                                              "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
