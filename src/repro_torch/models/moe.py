"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity dispatch.

The port of src/repro/models/moe.py's scatter path.  Dispatch is
scatter-based (no (T, E, C) one-hot einsum): tokens are ranked within
their expert by a stable sort of the top-k assignments, dropped beyond
capacity, and scattered into per-expert buffers (E, C, D); the expert FFNs
run batched over the leading E axis.

Matches DeepSeekMoE (arXiv:2401.06066) / DeepSeek-V3 (arXiv:2412.19437)
structure: fine-grained experts + shared experts + aux load-balance loss.

Over the ranks of a data × model mesh, under ``sharding_hints(mesh,
moe_a2a=True)``, the reference's gate (``hints.a2a_gate``: E % nm == 0,
E ≥ nm, outside a manual region) sends the layer through
``apply_moe_a2a``, the expert-parallel all-to-all dispatch: each rank
routes one group of the flat tokens (the reference's groups, over the data
axes and ``model``) with the capacity of its own group, exchanges the
(E, C, D) buffers with one all-to-all along ``model``, runs its E/nm
experts and sends the outputs back.  Elsewhere under the hints the scatter
path runs with the capacity of the whole batch, placed as the reference's
``hint_tokens`` and ``hint_moe_buffers`` place it: each data rank routes
its share of the tokens, and each model rank fills and runs its rows of
the (E·C, D) buffer (``_apply_moe_scatter``).  That path also carries the
tensor-parallel training step's gradients (``hints.RankLayout``'s
conventions: the buffer's rows all-gathered back, the f32 router's and the
aux loss's gradients); the all-to-all has no backward pass, as it is gated
off where the step runs.

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
from repro_torch.sharding import hints

EXPERTS = ("w_gate", "w_up", "w_down")
a2a_calls = 0       # apply_moe_a2a's dispatches (counted where it runs)


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


def _group_line(lay, axes):
    """The ranks whose token groups make up this rank's rows of the batch,
    as one line in group order (None: the group is all of them): along
    ``model`` when the data axes hold distinct rows, else every rank (or
    the data axes) when each rank holds every row."""
    comm = lay.comm
    if "model" in axes:
        return comm.model if lay.rows != slice(0, lay.batch) else comm.world
    if axes and lay.rows == slice(0, lay.batch):
        return comm.data
    return None


def apply_moe_a2a(cfg: ModelConfig, p: Params, x: torch.Tensor, lay
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style MoE over the ranks (src/repro/models/moe.py:163-274).

    ``x`` is this rank's piece of the (normed) residual and ``p`` its
    slices: E/nm experts, the router whole, the shared experts split as an
    MLP.  The flat tokens (B·S) are cut into the reference's groups over
    the data axes and ``model`` (``hints.moe_token_axes``); the rank's
    group is re-laid out from its residual piece (an all-gather along
    ``model``: with the sequence split, rank m holds positions of every
    row while group m is a run of consecutive tokens, and which tokens a
    group drops depends on which tokens it holds).  The group routes,
    ranks and drops with the capacity of its own token count; ONE
    all-to-all along ``model`` turns the (E, C, D) buffer into the local
    experts' (E/nm, nm·C, D); the reverse one brings the outputs back; the
    gates weight them on the group's tokens, and the groups' outputs are
    all-gathered back to the residual's layout.  The shared experts run as
    a split MLP on the rank's rows.  ``aux`` is the mean over every rank
    (every token shard), summed in rank order."""
    global a2a_calls
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k
    comm, nm = lay.comm, lay.nm
    d = x.shape[-1]
    total = lay.batch * lay.seq
    axes = hints.moe_token_axes(total, lay.mesh)
    groups = math.prod(lay.mesh.shape[a] for a in axes)
    g = 0
    if axes:
        g = comm.data.rank
        if "model" in axes:
            g = g * nm + lay.m
    t = total // groups
    entered = lay.enter(x)                       # this rank's rows, whole
    local = entered.reshape(-1, d)
    lo = g * t - lay.rows.start * lay.seq
    xg = local[lo:lo + t]                        # the rank's token group

    gate_vals, expert_ids, _, aux = route(cfg, p, xg)
    aux = comm.mean_world(aux)
    flat_expert = expert_ids.reshape(t * k)
    cap = capacity(cfg, t)
    rank = ranks(flat_expert)
    keep = rank < cap
    slot = flat_expert * cap + rank.clamp(max=cap - 1)
    src = xg.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buf = x.new_zeros((e * cap, d)).index_add_(0, slot, src)

    # THE dispatch: experts split over model, capacities concatenated
    recv = comm.all_to_all_model(buf.reshape(nm, e // nm, cap, d))
    expert_in = recv.transpose(0, 1).reshape(e // nm, nm * cap, d)
    out = _expert_ffn(cfg, p, expert_in)                 # (E/nm, nm·C, D)
    back = out.reshape(e // nm, nm, cap, d).transpose(0, 1)
    flat_out = comm.all_to_all_model(back.contiguous()).reshape(e * cap, d)
    a2a_calls += 1

    gathered = flat_out[slot]                            # (t·k, D)
    gates = (gate_vals.reshape(t * k) * keep).to(x.dtype)
    combined = (gathered * gates[:, None]).reshape(t, k, d).sum(1)
    line = _group_line(lay, axes)
    if line is not None:                 # the groups of this rank's rows
        combined = comm.gather_line(combined, 0, line)
    out = lay.piece(combined.reshape(-1, lay.seq, d))
    if moe.num_shared_experts:
        out = out + layers.apply_mlp_ranks(
            cfg, p["shared"], x, lay, moe.num_shared_experts * moe.d_ff_expert,
            entered)
    return out, aux


def _apply_moe_scatter(cfg: ModelConfig, p: Params, x: torch.Tensor, lay
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scatter path over the ranks where the all-to-all is gated off,
    laid out as the reference's hints place it.  Capacity couples every
    token of the batch, so a (token, slot) is ranked within its expert
    over the whole batch.

    ``hints.tokens_layout`` (``hint_tokens``): with the flat tokens over
    the data axes, each data rank routes its share; its ranks are offset
    by the counts of the shares before it, and aux is formed from the
    counts and probabilities summed over the shares.
    ``hints.moe_buffers_layout`` (``hint_moe_buffers``): with the (E·C, D)
    buffer over ``model``, each rank fills its rows of it from every data
    rank's share (summed over the data axes: a slot holds one token at
    most, so the sum is exact), runs the experts of those rows (its own
    where E/nm is whole) and all-gathers the outputs along ``model``;
    otherwise it fills and runs the whole buffer with every expert.  The
    shared experts run as a split MLP on the rank's piece."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k
    comm, d = lay.comm, x.shape[-1]
    total = lay.batch * lay.seq
    # this rank's rows, whole: every rank routes them alike
    entered = lay.join(x, 1) if lay.seq_split else x
    split = hints.tokens_layout((total, d), lay.mesh) is not None
    n_dp, r = (comm.data.world_size, comm.data.rank) if split else (1, 0)
    t = total // n_dp
    lo = r * t - lay.rows.start * lay.seq
    xt = entered.reshape(-1, d)[lo:lo + t]       # this data rank's share

    gate_vals, expert_ids, probs, aux = route(cfg, p, xt)
    flat_expert = expert_ids.reshape(t * k)
    rank = ranks(flat_expert)
    if n_dp > 1:
        counts = expert_counts(flat_expert, e).to(probs.dtype)
        stats = comm.gather_line(torch.cat([counts, probs.sum(0)])[None],
                                 0, comm.data)             # (n_dp, 2E)
        rank = rank + stats[:r, :e].sum(0).long()[flat_expert]
        every = stats.sum(0)
        aux = moe.router_aux_weight * e * torch.dot(
            every[:e] / (total * k), every[e:] / total)
    cap = capacity(cfg, total)
    keep = rank < cap
    slot = flat_expert * cap + rank.clamp(max=cap - 1)

    over_model = hints.moe_buffers_layout(e * cap, lay.mesh)
    n = e * cap // lay.nm if over_model else e * cap
    first = lay.m * n if over_model else 0
    mine = keep & (slot >= first) & (slot < first + n)
    src = lay.fork(xt).repeat_interleave(k, dim=0) * mine[:, None].to(x.dtype)
    buf = x.new_zeros((n, d)).index_add_(0, (slot - first).clamp(0, n - 1),
                                         src)
    if n_dp > 1:
        buf = comm.gather_line(buf[None], 0, comm.data).sum(0)
    # the experts of rows [first, first + n): whole ones, padded with zero
    # rows where the rows cut through an expert (E % nm != 0)
    e0, e1 = first // cap, -(-(first + n) // cap)
    w = dict(p)
    for name in EXPERTS:
        if p[name].shape[0] != e1 - e0:
            w[name] = lay.whole(p[name], 0, e)[e0:e1]
    head = first - e0 * cap
    run = F.pad(buf, (0, 0, head, (e1 - e0) * cap - head - n))
    out = _expert_ffn(cfg, w, run.reshape(e1 - e0, cap, d)).reshape(-1, d)
    out = out[head:head + n]
    if over_model:
        out = lay.join(out, 0)                                # (E·C, D)

    gathered = out[slot]                                      # (t·k, D)
    gates = (gate_vals.reshape(t * k) * keep).to(x.dtype)
    combined = (gathered * gates[:, None]).reshape(t, k, d).sum(1)
    if n_dp > 1 and lay.rows == slice(0, lay.batch):
        combined = comm.gather_line(combined, 0, comm.data)  # whole rows
    out = lay.piece(combined.reshape(-1, lay.seq, d))
    if moe.num_shared_experts:
        out = out + layers.apply_mlp_ranks(
            cfg, p["shared"], x, lay, moe.num_shared_experts * moe.d_ff_expert,
            entered)
    return out, lay.once(aux)


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


def expert_counts(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """The (token, slot) pairs routed to each of the ``e`` experts (int64):
    ``bincount(flat_expert, minlength=e)`` as a scatter-add of ones,
    whose output shape does not hang on the ids' values (so it also runs
    on ``meta`` tensors)."""
    return torch.zeros(e, dtype=torch.int64, device=flat_expert.device
                       ).index_add_(0, flat_expert, torch.ones_like(
                           flat_expert, dtype=torch.int64))


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, lay=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    With ``lay`` (a ``hints.RankLayout``: this rank's piece of x, its
    slices of p) the reference's gate picks the all-to-all dispatch
    (``apply_moe_a2a``) or the scatter path with the whole batch's
    capacity (``_apply_moe_scatter``)."""
    if lay is not None:
        if hints.moe_a2a_enabled() and hints.a2a_gate(cfg, lay.mesh):
            return apply_moe_a2a(cfg, p, x, lay)
        return _apply_moe_scatter(cfg, p, x, lay)
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
        counts = expert_counts(flat_expert, e)
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
