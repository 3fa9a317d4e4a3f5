"""The port's MoE FFN (``models/moe.py``) against the JAX package's scatter
path: the same top-k experts, the same tokens kept at the capacity, the
same Switch aux loss, and the output within 1e-5 · max |ref|.

Expert ids are compared before the outputs (``torch.topk`` and
``lax.top_k`` may order ties differently; the seeds here have none), and
the ranks against a numpy loop: the i-th assignment to an expert, in token
order, has rank i.  The cases cover the four MLP kinds, a capacity factor
that drops tokens, and a decode-sized batch under the capacity floor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import moe

ARCH = "deepseek-moe-16b"


def _cfgs(mlp, capacity_factor):
    out = []
    for pkg in (jconfigs, configs):
        cfg = pkg.get_config(ARCH, reduced=True)
        out.append(dataclasses.replace(
            cfg, mlp=mlp, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor)))
    return out


def _reference_routing(cfg, jp, xf):
    """The reference's routing, step for step (src/repro/models/moe.py:
    85-112): expert ids and the kept (token, slot) pairs."""
    moe_cfg = cfg.moe
    t, k = xf.shape[0], moe_cfg.top_k
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    flat = expert_ids.reshape(t * k)
    capacity = max(int(t * k / moe_cfg.num_experts
                       * moe_cfg.capacity_factor), min(t * k, 32))
    sort_idx = jnp.argsort(flat, stable=True)
    srt = flat[sort_idx]
    idx = jnp.arange(t * k, dtype=jnp.int32)
    start = jnp.concatenate([jnp.ones((1,), bool), srt[1:] != srt[:-1]])
    rank = jnp.zeros((t * k,), jnp.int32).at[sort_idx].set(
        idx - jax.lax.cummax(jnp.where(start, idx, 0)))
    return np.asarray(expert_ids), np.asarray(rank < capacity), capacity


@pytest.mark.parametrize("mlp,capacity_factor,b,s", [
    ("swiglu", 1.25, 2, 16),
    ("geglu", 0.5, 4, 32),     # drops tokens
    ("relu2", 1.0, 2, 1),      # decode-sized: the floor keeps every token
    ("gelu", 0.25, 4, 64),     # drops most
])
def test_apply_moe_matches_reference(mlp, capacity_factor, b, s):
    jcfg, cfg = _cfgs(mlp, capacity_factor)
    jp = jmoe.init_moe(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    p = model_params_from_numpy(tree, "cpu")
    x = np.random.default_rng(1).normal(size=(b, s, cfg.d_model))
    x = x.astype(np.float32)
    xf = x.reshape(b * s, cfg.d_model)

    want_ids, want_keep, want_cap = _reference_routing(jcfg, jp,
                                                       jnp.asarray(xf))
    _, ids, _, _ = moe.route(cfg, p, torch.as_tensor(xf))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    cap = moe.capacity(cfg, b * s)
    assert cap == want_cap
    keep = (moe.ranks(ids.reshape(-1)) < cap).numpy()
    np.testing.assert_array_equal(keep, want_keep)
    if capacity_factor < 1.0:
        assert not keep.all()

    want, want_aux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    got, aux = moe.apply_moe(cfg, p, torch.as_tensor(x))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def test_ranks_count_within_each_expert_in_token_order():
    rng = np.random.default_rng(2)
    flat = rng.integers(0, 5, size=200)
    seen: dict = {}
    want = []
    for e in flat:
        want.append(seen.get(e, 0))
        seen[e] = want[-1] + 1
    np.testing.assert_array_equal(moe.ranks(torch.as_tensor(flat)).numpy(),
                                  want)


def test_moe_param_tree_matches_reference():
    jcfg, cfg = _cfgs("swiglu", 1.25)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jmoe.init_moe(jcfg, jax.random.key(0)))
    got = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    flat = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items() if k != "shared"}
    flat["shared"] = {k: (tuple(v.shape), str(v.dtype).removeprefix(
        "torch.")) for k, v in got["shared"].items()}
    assert flat == want
