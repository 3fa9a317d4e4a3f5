"""The Mamba-2 mixer's share of one model rank, in one process, at the
reduced configuration (f32).

``param_specs`` cuts in_proj (D → [z | x | B | C | dt]) and the conv
([x | B | C] channels) into contiguous blocks over ``model`` that straddle
those boundaries.  A rank running its H / nm heads takes the head-aligned
columns instead (``ssm.head_columns``), cut before the product:

  * for 2 and 4 ranks each rank's product on its columns is those columns
    of the whole product, and its conv on its channels those channels of
    the whole conv, bit for bit; over the ranks the columns cover z, x and
    dt once and B / C on every rank (n_groups 1) or the rank's groups;
  * ``ssm.ssm_heads`` (a rank's partial mixer: its columns, its heads'
    scan, its rows of out_proj) summed over the ranks is the JAX package's
    ``ssm_forward`` of the whole layer on the same parameters and input
    within 1e-5 · max, through the plain scan and through the kernel
    route (its plain version on the CPU), for n_groups 1, 2 and 4.

The ranks' own run of it (the collectives, the split decode) is held in
tests/test_torch_mesh_forward.py and test_torch_tp_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers, ssm, transformer

RANKS = (2, 4)
GROUPS = (1, 2, 4)
B, S = 2, 64
TOL = 1e-5


def _configs(groups: int):
    """The port's and the JAX package's reduced config with ``groups``."""
    return tuple(dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, n_groups=groups)) for c in (
            configs.get_config("mamba2-1.3b", reduced=True),
            jconfigs.get_config("mamba2-1.3b", reduced=True)))


def _layer(jcfg, seed: int):
    """One mixer's parameters from the JAX init (random a_log / dt_bias /
    d_skip so the heads differ), as numpy and as port tensors."""
    tree = jax.tree.map(np.asarray, jssm.init_ssm(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias", "d_skip"):
        tree[k] = (tree[k] + rng.normal(scale=0.3, size=tree[k].shape)) \
            .astype(np.float32)
    return tree, model_params_from_numpy(tree, "cpu")


def _input(cfg, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("nm", RANKS)
def test_head_columns_are_the_whole_products_columns(nm, groups):
    """Each rank's cut product and cut conv equal the whole layer's on
    those columns, bit for bit; z, x and dt are covered once over the
    ranks and every rank reads the B / C columns of its heads' groups."""
    cfg, jcfg = _configs(groups)
    _, p = _layer(jcfg, 0)
    d_in, h, g, n = ssm.dims(cfg)
    x = torch.from_numpy(_input(cfg, 1))
    whole = x @ p["in_proj"]
    z, xbc, _ = ssm._split_proj(cfg, whole)
    conv = layers.apply_conv(p["conv"], xbc)
    seen = np.zeros(whole.shape[-1], dtype=int)
    for m in range(nm):
        proj_cols, conv_cols = ssm.head_columns(cfg, m, nm)
        assert torch.equal(x @ ssm.cut(p["in_proj"], proj_cols),
                           ssm.cut(whole, proj_cols))
        got = layers.apply_conv({"w": ssm.cut(p["conv"]["w"], conv_cols),
                                 "b": ssm.cut(p["conv"]["b"], conv_cols)},
                                ssm.cut(xbc, conv_cols))
        assert torch.equal(got, ssm.cut(conv, conv_cols))
        for a, b in proj_cols:
            seen[a:b] += 1
        g_lo, g_hi = ssm._rank_groups(cfg, m, nm)
        heads = range(m * h // nm, (m + 1) * h // nm)
        assert {i // (h // g) for i in heads} == set(range(g_lo, g_hi))
    bc = slice(2 * d_in, 2 * d_in + 2 * g * n)
    assert (np.delete(seen, np.r_[bc]) == 1).all()
    assert seen[bc].sum() == 2 * n * max(nm, g)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("nm", RANKS)
def test_rank_heads_sum_to_the_reference_mixer(nm, groups, use_kernel):
    """Σ over the ranks of ``ssm_heads`` (each with its rows of out_proj)
    is the JAX package's ``ssm_forward`` of the whole layer."""
    cfg, jcfg = _configs(groups)
    tree, p = _layer(jcfg, 2)
    x = _input(cfg, 3)
    want = np.asarray(jssm.ssm_forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(x)))
    d_in = ssm.dims(cfg)[0]
    assert ssm.heads_split(cfg, nm)
    got = sum(ssm.ssm_heads(
        cfg, dict(p, out_proj=p["out_proj"][m * d_in // nm:
                                            (m + 1) * d_in // nm]),
        torch.from_numpy(x), m, nm, use_kernel) for m in range(nm))
    err = float(np.abs(got.numpy().astype(np.float64) - want).max())
    assert err <= TOL * float(np.abs(want).max()), (nm, groups, err)


def test_heads_that_do_not_divide_are_not_split():
    """Two SSD heads, or six MLA heads, over four ranks: the layers are
    gathered whole (a layout choice, ``transformer.split_arch``); over two
    ranks they split.  The GQA stacks split at any count (their own heads
    or context branch); the RG-LRU hybrid and the encoder-decoder where
    nm divides their channels and heads."""
    cfg = configs.get_config("mamba2-1.3b", reduced=True)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, head_dim=cfg.ssm.expand * cfg.d_model // 2))
    assert ssm.dims(cfg)[1] == 2
    assert ssm.heads_split(cfg, 2) and not ssm.heads_split(cfg, 4)
    assert transformer.split_arch(cfg, 2)
    assert not transformer.split_arch(cfg, 4)
    mla = dataclasses.replace(configs.get_config("deepseek-v3-671b",
                                                 reduced=True),
                              num_heads=6, num_kv_heads=6)
    assert transformer.split_arch(mla, 2)
    assert not transformer.split_arch(mla, 4)
    gqa = configs.get_config("gemma-2b", reduced=True)
    assert all(transformer.split_arch(gqa, nm) for nm in (1, 2, 4, 3))
    # the RG-LRU hybrid splits where nm divides its width (256) and its
    # MLP (512); three ranks divide neither, and an MLP 510 wide splits
    # over 2 ranks only
    hybrid = configs.get_config("recurrentgemma-9b", reduced=True)
    assert all(transformer.split_arch(hybrid, nm) for nm in (1, 2, 4, 16))
    assert not transformer.split_arch(hybrid, 3)
    narrow = dataclasses.replace(hybrid, d_ff=510)
    assert transformer.split_arch(narrow, 2)
    assert not transformer.split_arch(narrow, 4)
    # the encoder-decoder where nm divides its heads (4 reduced, 16
    # published), the vision prefix's GQA decoder at any count
    encdec = configs.get_config("seamless-m4t-medium", reduced=True)
    assert transformer.split_arch(encdec, 4)
    assert not transformer.split_arch(encdec, 8)
    assert transformer.split_arch(configs.get_config("seamless-m4t-medium"),
                                  16)
    vlm = configs.get_config("internvl2-2b", reduced=True)
    assert all(transformer.split_arch(vlm, nm) for nm in (1, 2, 3, 4, 16))
