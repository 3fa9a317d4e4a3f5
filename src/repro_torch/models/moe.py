"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity dispatch.

The port of src/repro/models/moe.py's scatter path.  Dispatch is
scatter-based (no (T, E, C) one-hot einsum): tokens are ranked within
their expert by a stable sort of the top-k assignments, dropped beyond
capacity, and scattered into per-expert buffers (E, C, D); the expert FFNs
run batched over the leading E axis.

Matches DeepSeekMoE (arXiv:2401.06066) / DeepSeek-V3 (arXiv:2412.19437)
structure: fine-grained experts + shared experts + aux load-balance loss.

The reference's expert-parallel ``apply_moe_a2a`` runs only under an
active device mesh with ``moe_a2a`` hints (``sharding_hints``); it is not
ported yet (ROADMAP A.5 item 1) and refuses, and the port takes the scatter
path.  Its ``hints.hint_tokens`` and ``hints.hint_moe_buffers`` are
identities without a mesh and are left out.

Capacity couples a batch's rows: a token is dropped by its rank among
every earlier (token, slot) sent to its expert.  A caller that holds some
rows of a global batch on each of several ranks (the layerwise ADMM
trainer over ``data``) dispatches them as the global batch would inside
``global_rows``: capacity from the global token count, each rank's ranks
offset by the counts of the ranks before it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, dtype_of


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    moe = cfg.moe
    dt = dtype_of(cfg)
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.num_experts

    def stack_init(shape):
        return dense_init(gen, shape, dt, scale=1.0 / math.sqrt(shape[-2]))

    p: Params = {
        "router": dense_init(gen, (d, e), torch.float32),  # f32 router
        "w_gate": stack_init((e, d, f)),
        "w_up": stack_init((e, d, f)),
        "w_down": stack_init((e, f, d)),
    }
    if moe.num_shared_experts:
        p["shared"] = layers.init_mlp(cfg, gen, d,
                                      moe.num_shared_experts * f)
    return p


def _expert_ffn(cfg: ModelConfig, p: Params, xs: torch.Tensor
                ) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D), batched over the expert axis."""
    up = torch.bmm(xs, p["w_up"])
    if cfg.mlp in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp == "swiglu" else layers.gelu
        h = act(torch.bmm(xs, p["w_gate"])) * up
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(up))
    else:
        h = layers.gelu(up)
    return torch.bmm(h, p["w_down"])


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """Top-k routing of tokens xf (T, D): (renormalized gates (T, k),
    expert ids (T, k), router probabilities (T, E), Switch aux loss)."""
    moe = cfg.moe
    t = xf.shape[0]
    e, k = moe.num_experts, moe.top_k
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)     # (T, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # load-balance aux loss (Switch-style): E * Σ_e f_e · p̄_e
    flat = expert_ids.reshape(t * k)
    counts = probs.new_zeros(e).index_add_(0, flat, torch.ones_like(
        flat, dtype=probs.dtype))
    frac_tokens = counts / (t * k)
    aux = moe.router_aux_weight * e * torch.dot(frac_tokens, probs.mean(0))
    return gate_vals, expert_ids, probs, aux


_GLOBAL_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "moe_global_rows", default=None)


@contextlib.contextmanager
def global_rows(n_shards: int, offsets: Callable[[torch.Tensor],
                                                 torch.Tensor]):
    """Within: ``apply_moe`` takes its tokens as one of ``n_shards`` equal,
    consecutive row blocks of a global batch — capacity from the global
    token count, and each (token, slot)'s rank within its expert offset by
    ``offsets(counts)``: the (E,) counts of the blocks before this one,
    given this block's."""
    token = _GLOBAL_ROWS.set((n_shards, offsets))
    try:
        yield
    finally:
        _GLOBAL_ROWS.reset(token)


def apply_moe_a2a(cfg: ModelConfig, p: Params, x: torch.Tensor, mesh):
    """The reference's expert-parallel all-to-all dispatch (with its
    ``sharding_hints`` gate) is not ported yet."""
    raise NotImplementedError(
        "apply_moe_a2a and the sharding_hints that gate it are ROADMAP A.5 "
        "item 1; the scatter dispatch (apply_moe) computes the same values")


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert: the capacity factor's share, with a floor of
    min(T·k, 32) that keeps decode-sized batches drop-free."""
    moe = cfg.moe
    tk = tokens * moe.top_k
    return max(int(tk / moe.num_experts * moe.capacity_factor), min(tk, 32))


def ranks(flat_expert: torch.Tensor) -> torch.Tensor:
    """Rank of each (token, slot) within its expert, in token order: a
    stable sort, then the distance to the start of the expert's run (the
    reference's ``lax.cummax`` is ``torch.cummax``)."""
    n = flat_expert.shape[0]
    sort_idx = torch.argsort(flat_expert, stable=True)
    sorted_experts = flat_expert[sort_idx]
    idx = torch.arange(n, device=flat_expert.device)
    is_start = torch.ones_like(sorted_experts, dtype=torch.bool)
    is_start[1:] = sorted_experts[1:] != sorted_experts[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[sort_idx] = idx - group_start
    return rank


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    xf = x.reshape(t, d)
    gate_vals, expert_ids, _, aux = route(cfg, p, xf)
    flat_expert = expert_ids.reshape(t * k)
    shards = _GLOBAL_ROWS.get()
    cap = capacity(cfg, t if shards is None else t * shards[0])
    rank = ranks(flat_expert)
    if shards is not None:
        counts = torch.bincount(flat_expert, minlength=e)
        rank = rank + shards[1](counts)[flat_expert]
    keep = rank < cap

    # scatter tokens into (E·C, D) buffers by a masked scatter-add: every
    # kept (token, slot) owns a unique rank < capacity, so add == set, and
    # dropped tokens add zero
    slot = flat_expert * cap + rank.clamp(max=cap - 1)
    src = xf.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buf = x.new_zeros((e * cap, d)).index_add_(0, slot, src)
    expert_out = _expert_ffn(cfg, p, buf.reshape(e, cap, d))

    # gather back and weight by (renormalized, drop-masked) gates
    gathered = expert_out.reshape(e * cap, d)[slot]           # (T*k, D)
    gates = (gate_vals.reshape(t * k) * keep).to(x.dtype)
    combined = (gathered * gates[:, None]).reshape(t, k, d).sum(1)
    if cfg.moe.num_shared_experts:
        combined = combined + layers.apply_mlp(cfg, p["shared"], xf)
    return combined.reshape(b, s, d), aux
