"""Every attention architecture family of the port against the JAX
package, at the reduced configurations (f32): GQA/MQA with and without QKV
bias (qwen2-7b, gemma-2b, nemotron-4-15b), MLA + MoE + MTP
(deepseek-v3-671b), MoE (deepseek-moe-16b, moonshot-v1-16b-a3b), the
RG-LRU hybrid (recurrentgemma-9b), the vision prefix (internvl2-2b) and the
encoder-decoder (seamless-m4t-medium).

The reference's ``Model.init`` parameters are carried across by
``convert.model_params_from_numpy``.  Per architecture: the parameter tree
(key paths, shapes, dtypes, also of the port's own init); ``forward`` with
``use_kernel`` False and True (on the CPU the flash kernel's plain
version), logits, hidden and aux loss; ``loss`` (with the MTP loss where
the config has it) and ``prefill``; 12 cached ``decode_step`` calls and the
caches they leave (an encoder-decoder's cross caches filled from the
reference's encoder memory) — all within 1e-5 · max |ref|.  The port's
cached decode against its own forward is held to the reference test's
limit on probabilities (rtol 2e-2, atol 2e-3;
tests/test_decode_consistency.py), and the rolling decode of gemma-2b and
qwen2-7b with a window of 16 (tests/test_configs_smoke.py) against the
reference's over 20 steps, so the cache wraps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.build import make_model as jmake_model
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.build import make_model

ARCHS = [a for a in jconfigs.list_archs() if a != "mamba2-1.3b"]
TOL = 1e-5
B, S, S_ENC, STEPS = 2, 16, 24, 12


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


def _flat(tree, prefix=""):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens,
             "targets": np.roll(tokens, -1, axis=1).astype(np.int32)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.frontend.num_embeddings, cfg.d_model)) \
            .astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, S_ENC, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _cross_caches(cfg, dec_stack, memory):
    """Cross-attention k/v of every decoder layer from encoder memory, as
    tests/test_decode_consistency.py fills them (numpy)."""
    hd = cfg.resolved_head_dim
    b, s_mem, _ = memory.shape
    shape = (b, s_mem, cfg.num_kv_heads, hd)
    ks = np.stack([(memory @ w).reshape(shape)
                   for w in np.asarray(dec_stack["cross"]["k"])])
    vs = np.stack([(memory @ w).reshape(shape)
                   for w in np.asarray(dec_stack["cross"]["v"])])
    return ks.astype(np.float32), vs.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX model's parameters and its results on one batch."""
    jcfg = jconfigs.get_config(arch, reduced=True)
    jmodel = jmake_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux, h = jax.jit(jmodel.forward)(jparams, jbatch)
    loss, metrics = jax.jit(jmodel.loss)(jparams, jbatch)
    pre_logits, pre_caches = jax.jit(functools.partial(
        jmodel.prefill, max_len=32))(jparams, jbatch)

    caches = jmodel.init_cache(B, STEPS + 2)
    cross = None
    if jcfg.is_encoder_decoder:
        memory = np.asarray(jax.jit(jmodel.encode)(jparams, jbatch["frames"]))
        cross = _cross_caches(jcfg, tree["stack"]["dec"], memory)
        caches["dec"]["cross_k"] = jnp.asarray(cross[0])
        caches["dec"]["cross_v"] = jnp.asarray(cross[1])
    step = jax.jit(jmodel.decode_step)
    dec = []
    for t in range(STEPS):
        out, caches = step(jparams, caches,
                           jbatch["tokens"][:, t:t + 1])
        dec.append(np.asarray(out))
    return {
        "tree": tree, "batch": batch, "cross": cross,
        "logits": np.asarray(logits), "aux": float(aux), "h": np.asarray(h),
        "loss": float(loss),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "prefill_logits": np.asarray(pre_logits),
        "prefill_caches": jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                       pre_caches),
        "decode": dec, "caches": jax.tree.map(np.asarray, caches),
    }


def _port(arch):
    ref = _reference(arch)
    model = make_model(configs.get_config(arch, reduced=True))
    params = model_params_from_numpy(ref["tree"], "cpu")
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    return ref, model, params, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same key paths, shapes and dtypes, with the stacked layer axis, for
    the converted tree and the port's own init."""
    ref, model, params, _ = _port(arch)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(ref["tree"]).items()}
    for tree in (params, model.init(seed=0, device="cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in _flat(tree).items()}
        assert got == want


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, use_kernel):
    ref, model, params, batch = _port(arch)
    with torch.no_grad():
        logits, aux, h = model.forward(params, batch, use_kernel=use_kernel)
    assert logits.dtype == torch.float32
    _close(logits, ref["logits"])
    _close(h, ref["h"])
    if model.cfg.moe is None:
        assert float(aux) == ref["aux"] == 0.0
    else:
        np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_prefill_match_reference(arch):
    ref, model, params, batch = _port(arch)
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
        logits, caches = model.prefill(params, batch, max_len=32)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    assert set(metrics) == set(ref["metrics"])
    for key, want in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-5,
                                   atol=1e-7)
    _close(logits, ref["prefill_logits"])
    # the reference's prefill hands back empty caches (decode fills them)
    want = _flat(ref["prefill_caches"])
    got = _flat(caches)
    assert set(got) == set(want)
    for key, leaf in got.items():
        shape, dtype = want[key]
        assert (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")) \
            == (shape, dtype), key
        assert not leaf.any() or key.endswith("slot_pos"), key


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """12 cached decode steps, token by token, and the caches they leave."""
    ref, model, params, batch = _port(arch)
    caches = model.init_cache(B, STEPS + 2, device="cpu")
    if ref["cross"] is not None:
        caches["dec"]["cross_k"] = torch.as_tensor(ref["cross"][0])
        caches["dec"]["cross_v"] = torch.as_tensor(ref["cross"][1])
    tokens = batch["tokens"]
    for t in range(STEPS):
        with torch.no_grad():
            logits, caches = model.decode_step(params, caches,
                                               tokens[:, t:t + 1])
        _close(logits, ref["decode"][t])
    want = _flat(ref["caches"])
    got = _flat(caches)
    assert set(got) == set(want)
    for key, leaf in got.items():
        if leaf.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(leaf.numpy(), want[key], key)
        elif np.abs(want[key]).max() > 0:
            _close(leaf, want[key])
        else:
            assert not leaf.any(), key


def _prefix_free(cfg):
    """A vision config with a prefix of 0 embeddings: decode takes tokens
    only, so its forward is compared without the prefix."""
    if cfg.arch_type != "vlm":
        return cfg
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, num_embeddings=0))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own check, as tests/test_decode_consistency.py runs it:
    token-by-token cached decode reproduces the full forward on
    probabilities (the port's init, seed 0).  The encoder-decoder decodes
    against cross caches filled from its own encoder's memory."""
    cfg = _prefix_free(configs.get_config(arch, reduced=True))
    model = make_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=1).items()}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.zeros((B, 0, cfg.d_model))
    tokens = batch["tokens"][:, :STEPS]
    batch["tokens"] = batch["targets"] = tokens
    with torch.no_grad():
        full, _, _ = model.forward(params, batch)
        caches = model.init_cache(B, STEPS + 2, device="cpu")
        if cfg.is_encoder_decoder:
            memory = model.encode(params, batch["frames"])
            ks, vs = _cross_caches(
                cfg, transformer.tree_map(lambda t: t.numpy(),
                                          params["stack"]["dec"]),
                memory.numpy())
            caches["dec"]["cross_k"] = torch.as_tensor(ks)
            caches["dec"]["cross_v"] = torch.as_tensor(vs)
        dec = []
        for t in range(STEPS):
            logits, caches = model.decode_step(params, caches,
                                               tokens[:, t:t + 1])
            dec.append(logits[:, 0])
    p_ref = torch.softmax(full.float(), dim=-1).numpy()
    p_dec = torch.softmax(torch.stack(dec, dim=1).float(), dim=-1).numpy()
    np.testing.assert_allclose(p_dec, p_ref, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-7b"])
def test_rolling_decode_matches_reference(arch):
    """The rolling cache (long_500k's decode) with a window of 16: 20 steps
    against the reference's, so the 16 slots wrap."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                               sliding_window=16)
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              sliding_window=16)
    jmodel, model = jmake_model(jcfg), make_model(cfg)
    jparams = _reference(arch)["tree"]
    params = model_params_from_numpy(jparams, "cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    jcaches = jmodel.init_cache(1, 64, rolling=True)
    caches = model.init_cache(1, 64, rolling=True, device="cpu")
    assert tuple(caches["attn_mlp"]["k"].shape[:3]) == (cfg.num_layers, 1, 16)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, rolling=True))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 20))
    for t in range(20):
        tok = tokens[:, t:t + 1].astype(np.int32)
        want, jcaches = step(jparams, jcaches, jnp.asarray(tok))
        with torch.no_grad():
            got, caches = model.decode_step(params, caches,
                                            torch.as_tensor(tok),
                                            rolling=True)
        _close(got, want)
    np.testing.assert_array_equal(caches["attn_mlp"]["slot_pos"].numpy(),
                                  np.asarray(jcaches["attn_mlp"]["slot_pos"]))


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, rolling):
    """The published configuration's caches at every input shape, on the
    ``meta`` device: the reference's key paths, shapes and dtypes (the
    rolling window, the hybrid's local window, MLA's latent cache and the
    decoder's cross caches included)."""
    model = make_model(configs.get_config(arch))
    jmodel = jmake_model(jconfigs.get_config(arch))
    for name, shape in configs.INPUT_SHAPES.items():
        got = _flat(model.cache_specs(shape, rolling=rolling))
        want = _flat(jmodel.cache_specs(jconfigs.INPUT_SHAPES[name],
                                        rolling=rolling))
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."),
                    v.device.type) for k, v in got.items()} \
            == {k: (v.shape, str(v.dtype), "meta") for k, v in want.items()}
