"""The RG-LRU block's share of one model rank, in one process, at the
reduced configuration (f32, W = 256: eight diagonal blocks of 32).

``param_specs`` splits the block channel-parallel over ``model``: W/nm
columns of in_x / in_gate and of the conv, the same rows of ``out``, the
block-diagonal gates replicated.  A rank's gates read whole blocks
(``rglru.channel_cut``): with nm dividing 8 its channels are whole
blocks; with nm = 16 they are half of one, and the rank forms the conv
output of the whole block before keeping its own half.  For nm = 2, 4 and
16, on the same numpy operands:

  * Σ over the ranks of ``rglru.rglru_channels`` (each on its cut of the
    block, ``_cut``) is the JAX package's ``rglru_block_forward``
    within 1e-5 · max;
  * one decode token: Σ over the ranks of ``rglru.rglru_step_channels``'
    outputs, their new conv states and h joined in rank order, are the
    JAX ``rglru_block_step``'s within the same bound, from a random state.

The ranks' own run of it (the collectives, the cache write-back) is held
in tests/test_torch_mesh_forward.py and test_torch_tp_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers, rglru

RANKS = (2, 4, 16)
B, S = 2, 48
TOL = 1e-5


def _block(seed: int):
    """One block's parameters from the JAX init (random gate biases and Λ
    so the channels differ), as numpy and as port tensors."""
    jcfg = jconfigs.get_config("recurrentgemma-9b", reduced=True)
    tree = jax.tree.map(np.asarray,
                        jrglru.init_rglru_block(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for k in ("gate_a_b", "gate_x_b", "lam", "conv"):
        if k == "conv":
            tree[k]["b"] = rng.normal(scale=0.2, size=tree[k]["b"].shape) \
                .astype(np.float32)
            continue
        tree[k] = (tree[k] + rng.normal(scale=0.5, size=tree[k].shape)) \
            .astype(np.float32)
    return jcfg, tree, model_params_from_numpy(tree, "cpu")


def _cut(p, own: slice, span: slice):
    """A rank's cut of a whole block's parameters: in_x and the conv over
    ``span``'s channels, in_gate over ``own``'s columns, ``out`` over its
    rows; the gates, their biases and Λ whole."""
    return dict(p, in_x=p["in_x"][:, span], in_gate=p["in_gate"][:, own],
                conv={"w": p["conv"]["w"][:, span],
                      "b": p["conv"]["b"][span]},
                out=p["out"][own])


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("nm", RANKS)
def test_channel_cut_covers_the_width_in_whole_blocks(nm):
    """Each rank's channels are W/nm, disjoint over the ranks and covering
    W; its span is the whole blocks they lie in (its own channels where
    nm divides 8, the block of two ranks at nm = 16)."""
    cfg = configs.get_config("recurrentgemma-9b", reduced=True)
    w = rglru.width(cfg)
    bs = w // rglru.N_DIAG_BLOCKS
    seen = np.zeros(w, dtype=int)
    for m in range(nm):
        own, span = rglru.channel_cut(cfg, nm, m)
        seen[own] += 1
        assert own.stop - own.start == w // nm
        assert span.start % bs == 0 and span.stop % bs == 0
        assert span.start <= own.start < own.stop <= span.stop
        assert (span == own) == (rglru.N_DIAG_BLOCKS % nm == 0)
        if nm == 16:
            assert span.stop - span.start == bs
    assert (seen == 1).all()
    assert rglru.channels_split(cfg, nm)


@pytest.mark.parametrize("nm", RANKS)
def test_rank_channels_sum_to_the_reference_block(nm):
    """Σ over the ranks of ``rglru_channels`` is the JAX
    ``rglru_block_forward`` of the whole block."""
    jcfg, tree, p = _block(nm)
    cfg = configs.get_config("recurrentgemma-9b", reduced=True)
    x = np.random.default_rng(1).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    want = np.asarray(jrglru.rglru_block_forward(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    got = 0
    for m in range(nm):
        own, span = rglru.channel_cut(cfg, nm, m)
        got = got + rglru.rglru_channels(cfg, _cut(p, own, span),
                                         torch.from_numpy(x), own, span)
    _close(got.numpy(), want, ("forward", nm))


@pytest.mark.parametrize("nm", RANKS)
def test_rank_channels_step_the_reference_block(nm):
    """One token from a random state: the ranks' partial outputs summed,
    their conv states and h joined in rank order, against the JAX
    ``rglru_block_step``; each rank's gate input, where it reads past its
    channels, is the join of the ranks' conv outputs."""
    jcfg, tree, p = _block(10 + nm)
    cfg = configs.get_config("recurrentgemma-9b", reduced=True)
    w = rglru.width(cfg)
    rng = np.random.default_rng(2)
    x_t = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.normal(size=(B, cfg.hybrid.conv_kernel - 1, w))
             .astype(np.float32),
             "h": rng.normal(size=(B, w)).astype(np.float32)}
    want, want_c = jrglru.rglru_block_step(
        jcfg, jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(x_t))
    xt = torch.from_numpy(x_t)
    state = torch.from_numpy(cache["conv"])
    h = torch.from_numpy(cache["h"])
    cuts = [rglru.channel_cut(cfg, nm, m) for m in range(nm)]

    def sig_of(own):
        q = _cut(p, own, own)
        return layers.apply_conv_step(q["conv"], state[..., own],
                                      xt[:, 0] @ q["in_x"])[0]

    joined = torch.cat([sig_of(own) for own, _ in cuts], -1)

    def join(t):
        assert torch.equal(t, joined[:, own])
        return joined

    out, states, hs = 0, [], []
    for own, span in cuts:
        o, c, h_own = rglru.rglru_step_channels(
            cfg, _cut(p, own, own), state[..., own], h, xt, own,
            span, join)
        out = out + o
        states.append(c)
        hs.append(h_own)
    _close(out.numpy(), np.asarray(want), ("step", nm))
    _close(torch.cat(states, -1).numpy(), np.asarray(want_c["conv"]),
           ("conv state", nm))
    _close(torch.cat(hs, -1).numpy(), np.asarray(want_c["h"]), ("h", nm))
