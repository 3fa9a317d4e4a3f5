"""The port's attention modules against the JAX package: RoPE, the four
MLP kinds, ``block_causal_attention``, the kernel route of ``attend`` (the
plain version of ``ops.flash_attention`` on the CPU), and the GQA (full
and rolling) and MLA decode steps.

Operands come from numpy seeds and go through both packages in f32.  The
limit is 1e-5 · max |ref| (the same arithmetic summed in another order).
The kernel route is held to the reference's window semantics (above the
chunk the window applies with or without ``causal``; at or below it only
when causal) and to MLA's padding of v with zero columns.  A decode step
writes the port's cache in place, so each step is compared on a clone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.build import make_model as jmake_model
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import attention, layers, transformer

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


def _cfgs(arch, **changes):
    """(the reference's reduced config, the port's), with ``changes``."""
    return (dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                                **changes),
            dataclasses.replace(configs.get_config(arch, reduced=True),
                                **changes))


def _pair(tree):
    """A numpy tree as (JAX tree, port tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            model_params_from_numpy(tree, "cpu"))


# ---------------------------------------------------------------------------
# RoPE and the MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,theta", [(64, 10000.0), (16, 1e6)])
def test_apply_rope_matches_reference(hd, theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 33, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 33)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
def test_apply_mlp_matches_reference(mlp):
    jcfg, cfg = _cfgs("qwen2-7b", mlp=mlp)
    jp = jlayers.init_mlp(jcfg, jax.random.key(1), cfg.d_model, 96)
    jp, p = _pair(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model))
    x = x.astype(np.float32)
    want = jlayers.apply_mlp(jcfg, jp, jnp.asarray(x))
    got = layers.apply_mlp(cfg, p, torch.as_tensor(x))
    _close(got, want)
    own = layers.init_mlp(cfg, torch.Generator().manual_seed(0), cfg.d_model,
                          96)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jp.items()}


# ---------------------------------------------------------------------------
# block-causal attention and the kernel route
# ---------------------------------------------------------------------------

# (b, s, hq, hkv, qk_hd, v_hd, causal, window, chunk)
ATTENTION_CASES = [
    (2, 24, 4, 2, 16, 16, True, None, 2048),     # GQA, one chunk
    (2, 24, 4, 1, 16, 16, True, 5, 2048),        # MQA, window
    (1, 24, 4, 4, 16, 16, False, None, 2048),    # non-causal
    (1, 24, 4, 2, 16, 16, False, 5, 2048),       # non-causal, window ignored
    (2, 64, 4, 2, 16, 16, True, None, 16),       # four chunks
    (2, 64, 4, 1, 16, 16, True, 20, 16),         # chunks, window
    (1, 64, 4, 2, 16, 16, False, None, 16),      # chunks, non-causal
    (1, 64, 4, 2, 16, 16, False, 20, 16),        # chunks, non-causal window
    (2, 24, 4, 4, 24, 16, True, None, 2048),     # v_hd < qk_hd (MLA)
    (1, 64, 4, 4, 24, 16, True, 20, 16),         # v_hd < qk_hd, chunks
]


def _qkv(b, s, hq, hkv, qk_hd, v_hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, hq, qk_hd), (b, s, hkv, qk_hd),
                          (b, s, hkv, v_hd))]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("b,s,hq,hkv,qk_hd,v_hd,causal,window,chunk",
                         ATTENTION_CASES)
def test_attention_routes_match_block_causal_reference(
        b, s, hq, hkv, qk_hd, v_hd, causal, window, chunk, use_kernel):
    """Both routes of ``attend`` return the reference's
    ``block_causal_attention``; on the CPU the kernel route is the plain
    version of ``ops.flash_attention`` (with v padded where v_hd < qk_hd)."""
    q, k, v = _qkv(b, s, hq, hkv, qk_hd, v_hd)
    want = jattn.block_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
        chunk=chunk)
    got = attention.attend(*(torch.as_tensor(a) for a in (q, k, v)),
                           causal=causal, window=window,
                           use_kernel=use_kernel, chunk=chunk)
    _close(got, want)


def test_kernel_route_window_semantics():
    """Non-causal at or below the chunk: the reference drops the window,
    and the kernel route passes none; above the chunk both apply it."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 32, 2, 2, 8, 8))
    full = attention.attend(q, k, v, causal=False, use_kernel=True)
    short = attention.attend(q, k, v, causal=False, window=3,
                             use_kernel=True)
    torch.testing.assert_close(short, full, rtol=0, atol=0)
    chunked = attention.attend(q, k, v, causal=False, window=3,
                               use_kernel=True, chunk=8)
    assert not torch.allclose(chunked, full)
    _close(chunked, attention.block_causal_attention(
        q, k, v, causal=False, window=3, chunk=8))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_both_routes_refuse_a_length_off_the_chunk(use_kernel):
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 40, 2, 1, 8, 8))
    with pytest.raises(ValueError, match="multiple"):
        attention.attend(q, k, v, use_kernel=use_kernel, chunk=16)


def test_flash_plain_version_against_the_mla_padding():
    """MLA through the kernel route pads v from v_hd to qk_hd with zero
    columns: the first v_hd columns equal attention with the narrow v, the
    padded ones are zero, and the scale stays 1/√qk_hd."""
    from repro_torch.kernels import ops
    q, k, v = (torch.as_tensor(a) for a in _qkv(2, 24, 4, 4, 24, 16))
    padded = ops.flash_attention(q, k, torch.nn.functional.pad(v, (0, 8)))
    assert not padded[..., 16:].any()
    want = jattn.block_causal_attention(*(jnp.asarray(t.numpy())
                                          for t in (q, k, v)))
    _close(padded[..., :16], want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mla_forward_matches_reference(use_kernel):
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp = jattn.init_attention(jcfg, jax.random.key(2))
    jp, p = _pair(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).normal(size=(2, 20, cfg.d_model))
    x = x.astype(np.float32)
    want = jattn.mla_forward(jcfg, jp, jnp.asarray(x), window=7)
    got = attention.mla_forward(cfg, p, torch.as_tensor(x), window=7,
                                use_kernel=use_kernel)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 1000])
@pytest.mark.parametrize("s", [64, 4096])
def test_encoder_stack_window_edge(s, window):
    """The non-causal encoder with a window, through the reduced
    seamless-m4t's ``enc`` stack: at S ≤ CHUNK the reference ignores the
    window, above it the window applies; the kernel route (its plain
    version here) follows both."""
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    jstack = jmake_model(jcfg).init(jax.random.key(0))["stack"]
    stack = model_params_from_numpy(jax.tree.map(np.asarray, jstack), "cpu")
    x = np.random.default_rng(3).normal(size=(1, s, cfg.d_model))
    x = x.astype(np.float32)
    want, _ = jtransformer.apply_stack(jcfg, jstack, jnp.asarray(x),
                                       window=window, only_kinds=("enc",))
    for use_kernel in (False, True):
        with torch.no_grad():
            got, _ = transformer.apply_stack(cfg, stack, torch.as_tensor(x),
                                             window=window,
                                             use_kernel=use_kernel,
                                             only_kinds=("enc",))
        _close(got, want)


# ---------------------------------------------------------------------------
# cached decode steps
# ---------------------------------------------------------------------------

def _clone(cache):
    return transformer.tree_map(lambda t: t.clone(), cache)


@pytest.mark.parametrize("rolling,window,max_len", [
    (False, None, 16), (True, 5, 16), (False, 5, 16), (True, None, 8)])
def test_gqa_decode_steps_match_reference(rolling, window, max_len):
    """12 steps of ``gqa_decode_step`` (QKV bias, GQA); with ``rolling``
    the cache holds min(max_len, window) slots and wraps."""
    jcfg, cfg = _cfgs("qwen2-7b", sliding_window=window)
    jp = jattn.init_attention(jcfg, jax.random.key(4))
    tree = jax.tree.map(np.asarray, jp)
    tree["q_b"] = np.random.default_rng(5).normal(size=tree["q_b"].shape) \
        .astype(np.float32)
    jp, p = _pair(tree)
    jcache = jattn.init_gqa_cache(jcfg, 2, max_len, rolling=rolling)
    cache = attention.init_gqa_cache(cfg, 2, max_len, rolling=rolling,
                                     device=torch.device("cpu"))
    xs = np.random.default_rng(6).normal(size=(12, 2, 1, cfg.d_model))
    for x in xs.astype(np.float32):
        want, jcache = jattn.gqa_decode_step(jcfg, jp, jcache,
                                             jnp.asarray(x), rolling=rolling)
        got, cache = attention.gqa_decode_step(cfg, p, _clone(cache),
                                               torch.as_tensor(x),
                                               rolling=rolling)
        _close(got, want)
    for key in ("k", "v", "slot_pos", "pos"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=1e-5, atol=1e-6)


def test_mla_decode_steps_match_reference():
    """12 absorbed MLA decode steps against the reference's, and the
    latent cache they leave."""
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp, p = _pair(jax.tree.map(np.asarray,
                               jattn.init_attention(jcfg, jax.random.key(7))))
    jcache = jattn.init_mla_cache(jcfg, 2, 14)
    cache = attention.init_mla_cache(cfg, 2, 14, torch.device("cpu"))
    xs = np.random.default_rng(8).normal(size=(12, 2, 1, cfg.d_model))
    for x in xs.astype(np.float32):
        want, jcache = jattn.mla_decode_step(jcfg, jp, jcache,
                                             jnp.asarray(x))
        got, cache = attention.mla_decode_step(cfg, p, _clone(cache),
                                               torch.as_tensor(x))
        _close(got, want)
    for key in ("c_kv", "k_rope"):
        _close(cache[key], jcache[key])
    assert int(cache["pos"]) == int(jcache["pos"]) == 12


def test_decode_step_writes_the_cache_in_place():
    cfg = configs.get_config("qwen2-7b", reduced=True)
    p = attention.init_attention(cfg, torch.Generator().manual_seed(0))
    cache = attention.init_gqa_cache(cfg, 1, 4, device=torch.device("cpu"))
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, out = attention.gqa_decode_step(cfg, p, cache,
                                       torch.ones((1, 1, cfg.d_model)))
    assert out is cache and int(cache["pos"]) == 1
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert cache["slot_pos"].tolist() == [0, -1, -1, -1]
    assert cache["k"][:, 0].abs().sum() > 0 and not cache["k"][:, 1:].any()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("s,chunk,window,causal", [
    (16, 2048, None, True), (16, 2048, 5, True), (16, 2048, None, False),
    (32, 8, None, True), (32, 8, 6, True), (32, 8, 6, False)])
@pytest.mark.parametrize("nm", [2, 4])
def test_query_offset_slice_equals_rows_of_the_whole_call(use_kernel, s,
                                                          chunk, window,
                                                          causal, nm):
    """A context-parallel rank's query rows [m·S/nm, (m+1)·S/nm) at query
    offset m·S/nm against every key give the same rows as the whole call,
    on both routes (the plain ``block_causal_attention`` — at and above
    its chunk — and the flash kernel's plain version), within 1e-5 ·
    max; offset 0 over the whole sequence is the call without an
    offset, bit for bit."""
    rng = np.random.default_rng(s + nm)
    q = torch.from_numpy(rng.normal(size=(2, s, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, s, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, s, 2, 8)).astype(np.float32))
    kw = dict(causal=causal, window=window, use_kernel=use_kernel,
              chunk=chunk)
    whole = attention.attend(q, k, v, **kw)
    assert torch.equal(attention.attend(q, k, v, q_offset=0, **kw), whole)
    n = s // nm
    for m in range(nm):
        rows = attention.attend(q[:, m * n:(m + 1) * n], k, v,
                                q_offset=m * n, **kw)
        _close(rows, whole[:, m * n:(m + 1) * n].numpy())
