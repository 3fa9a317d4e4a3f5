"""Composable transformer stacks for every architecture family.

The port of src/repro/models/transformer.py.  A model is a list of
segments (kind, count); each segment's per-layer parameters are stacked
along a leading ``count`` axis, as in the reference, so parameters convert
leaf for leaf.  The reference's ``lax.scan`` over that axis is a Python
loop over index 0 of each stacked leaf here.

Over the ranks of a data × model mesh under ``sharding_hints``
(``apply_stack_ranks``, ``decode_stack_ranks``) each rank holds its slices
of every layer by ``param_specs`` (and of every cache by ``cache_specs``);
a layer's slices are all-gathered over the data axes (the FSDP leg) as it
runs.  Every family runs split where ``split_arch`` holds: the residual
lives between layers as the rank's (B/n_dp, S/nm, D) piece
(``hints.residual_layout``, the reference's ``hint_residual``; whole along
``model`` where nm does not divide S, as in a decode step), each split
sublayer all-gathers it along ``model`` at entry, computes on the rank's
heads (GQA, MLA, the SSD mixer, cross-attention), channels (the RG-LRU) or
columns of the MLP and reduce-scatters its partial sums at exit; a decode
step runs on the rank's slices of the caches.  Where nm does not divide
the heads or channels the arch is placed the same way but computes whole:
each layer's slices are all-gathered along all their axes (the routed
experts' along the data axes only: the all-to-all dispatch still runs on
them) and its activations stay whole along ``model``.  Both carry
gradients (the tensor-parallel training step; ``hints``' two conventions),
with remat per layer, collectives included.

Segment kinds:
  attn_mlp    pre-norm attention (GQA/MQA/MLA per cfg) + dense FFN
  attn_moe    attention + MoE FFN (shared + routed experts)
  ssm         Mamba-2 SSD mixer (no FFN)
  hybrid      one (rglru, rglru, local-attn) period, each with FFN
  rglru_mlp   single RG-LRU block + FFN (hybrid tail layers)
  enc         bidirectional encoder layer (enc-dec archs)
  dec         causal self-attn + cross-attn + FFN decoder layer

``use_kernel`` routes the SSD scan and every full-sequence self-attention
(``attn_mlp``, ``attn_moe``, the hybrid's local attention, ``enc`` and the
``dec`` self-attention) through their kernels; cross-attention and decode
steps are plain torch, as in the reference.
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe as moe_lib, rglru, ssm
from repro_torch.models.layers import Params
from repro_torch.sharding import hints, partition


# ---------------------------------------------------------------------------
# segment plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


def arch_segments(cfg: ModelConfig) -> list[Segment]:
    if cfg.is_encoder_decoder:
        return [Segment("enc", cfg.num_layers),
                Segment("dec", cfg.num_decoder_layers)]
    if cfg.arch_type == "ssm":
        return [Segment("ssm", cfg.num_layers)]
    if cfg.hybrid is not None:
        period = len(cfg.hybrid.pattern)
        n_periods, tail = divmod(cfg.num_layers, period)
        segs = [Segment("hybrid", n_periods)]
        if tail:
            segs.append(Segment("rglru_mlp", tail))
        return segs
    if cfg.moe is not None:
        segs = []
        if cfg.moe.first_dense_layers:
            segs.append(Segment("attn_mlp", cfg.moe.first_dense_layers))
        segs.append(Segment("attn_moe",
                            cfg.num_layers - cfg.moe.first_dense_layers))
        return segs
    return [Segment("attn_mlp", cfg.num_layers)]


# ---------------------------------------------------------------------------
# trees of tensors (nested dicts)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map2(fn: Callable, a, b):
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _stacked(make: Callable[[], Params], count: int,
             keep: Optional[Callable] = None) -> Params:
    """``count`` trees from ``make()`` stacked leaf-wise along a new leading
    axis, filled one tree at a time: the peak is the stack and one tree,
    not two stacks.  ``keep(tree)`` (a rank's slices) is applied to each
    tree as it is made."""
    out = None
    for i in range(count):
        tree = make()
        if keep is not None:
            tree = keep(tree)
        if out is None:
            out = tree_map(lambda leaf: leaf.new_empty((count,) + leaf.shape),
                           tree)
        tree_map2(lambda slot, leaf: slot.copy_(leaf), _layer(out, i), tree)
    return out


def _layer(tree, i: int):
    return tree_map(lambda leaf: leaf[i], tree)


def _layers(tree, count: int) -> list[Params]:
    """The ``count`` layers of a stacked tree, as views.  ``unbind`` gives
    them all at once, so under autograd each stacked leaf's gradient is one
    ``stack`` of the layers' gradients, not a full-size tensor per layer."""
    parts = tree_map(lambda leaf: leaf.unbind(0), tree)
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(count)]


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def _dense_ff_width(cfg: ModelConfig) -> int:
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        return cfg.moe.dense_d_ff or cfg.d_ff
    return cfg.d_ff


def init_layer(cfg: ModelConfig, kind: str, gen: torch.Generator) -> Params:
    dev = gen.device

    def norm():
        return layers.init_norm(cfg, cfg.d_model, dev)

    def mlp(d_ff=cfg.d_ff):
        return layers.init_mlp(cfg, gen, cfg.d_model, d_ff)

    if kind in ("attn_mlp", "enc"):
        d_ff = _dense_ff_width(cfg) if kind == "attn_mlp" else cfg.d_ff
        return {"norm1": norm(), "attn": attention.init_attention(cfg, gen),
                "norm2": norm(), "mlp": mlp(d_ff)}
    if kind == "attn_moe":
        return {"norm1": norm(), "attn": attention.init_attention(cfg, gen),
                "norm2": norm(), "moe": moe_lib.init_moe(cfg, gen)}
    if kind == "ssm":
        return {"norm": norm(), "mixer": ssm.init_ssm(cfg, gen)}
    if kind == "hybrid":
        p: Params = {}
        for i, blk in enumerate(cfg.hybrid.pattern):
            sub = {"norm1": norm(), "norm2": norm(), "mlp": mlp()}
            if blk == "rglru":
                sub["rg"] = rglru.init_rglru_block(cfg, gen)
            else:
                sub["attn"] = attention.init_attention(cfg, gen)
            p[f"blk{i}"] = sub
        return p
    if kind == "rglru_mlp":
        return {"norm1": norm(), "rg": rglru.init_rglru_block(cfg, gen),
                "norm2": norm(), "mlp": mlp()}
    if kind == "dec":
        return {"norm1": norm(), "attn": attention.init_attention(cfg, gen),
                "norm_x": norm(),
                "cross": attention.init_cross_attention(cfg, gen),
                "norm2": norm(), "mlp": mlp()}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# per-layer forward (full sequence)
# ---------------------------------------------------------------------------

def _attn_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor, *, causal=True,
              window=None, use_kernel=False) -> torch.Tensor:
    if cfg.mla is not None:
        return attention.mla_forward(cfg, p, x, window=window,
                                     use_kernel=use_kernel)
    return attention.gqa_forward(cfg, p, x, causal=causal, window=window,
                                 use_kernel=use_kernel)


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, *,
                window: Optional[int] = None,
                memory: Optional[torch.Tensor] = None,
                use_kernel: bool = False, lay=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss).  ``lay``: over ranks, the MoE layer's
    (``moe.apply_moe``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def mlp(sub, x):
        return layers.apply_mlp(cfg, sub["mlp"],
                                layers.apply_norm(cfg, sub["norm2"], x))

    if kind in ("attn_mlp", "enc", "attn_moe", "dec"):
        x = x + _attn_fwd(cfg, p["attn"],
                          layers.apply_norm(cfg, p["norm1"], x),
                          causal=kind != "enc", window=window,
                          use_kernel=use_kernel)
        if kind == "dec":
            x = x + attention.gqa_cross_forward(
                cfg, p["cross"], layers.apply_norm(cfg, p["norm_x"], x),
                memory)
        if kind == "attn_moe":
            h, aux = moe_lib.apply_moe(cfg, p["moe"],
                                       layers.apply_norm(cfg, p["norm2"], x),
                                       lay)
            x = x + h
        else:
            x = x + mlp(p, x)
    elif kind == "ssm":
        x = x + ssm.ssm_forward(cfg, p["mixer"],
                                layers.apply_norm(cfg, p["norm"], x),
                                use_kernel=use_kernel)
    elif kind == "hybrid":
        for i, blk in enumerate(cfg.hybrid.pattern):
            sub = p[f"blk{i}"]
            h_in = layers.apply_norm(cfg, sub["norm1"], x)
            if blk == "rglru":
                x = x + rglru.rglru_block_forward(cfg, sub["rg"], h_in)
            else:
                x = x + attention.gqa_forward(
                    cfg, sub["attn"], h_in, causal=True,
                    window=cfg.hybrid.local_window, use_kernel=use_kernel)
            x = x + mlp(sub, x)
    elif kind == "rglru_mlp":
        x = x + rglru.rglru_block_forward(
            cfg, p["rg"], layers.apply_norm(cfg, p["norm1"], x))
        x = x + mlp(p, x)
    else:
        raise ValueError(kind)
    return x, aux


# ---------------------------------------------------------------------------
# per-layer decode step (one token against the layer's cache)
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     rolling: bool, memory_len: int = 0,
                     device: torch.device | None = None) -> Params:
    if kind in ("attn_mlp", "attn_moe"):
        if cfg.mla is not None:
            return attention.init_mla_cache(cfg, batch, max_len, device)
        return attention.init_gqa_cache(cfg, batch, max_len, rolling, device)
    if kind == "ssm":
        return ssm.init_ssm_cache(cfg, batch, device)
    if kind == "hybrid":
        c: Params = {}
        for i, blk in enumerate(cfg.hybrid.pattern):
            if blk == "rglru":
                c[f"blk{i}"] = rglru.init_rglru_cache(cfg, batch, device)
            else:
                c[f"blk{i}"] = attention.init_gqa_cache(
                    cfg, batch, min(max_len, cfg.hybrid.local_window),
                    rolling=True, device=device)
        return c
    if kind == "rglru_mlp":
        return rglru.init_rglru_cache(cfg, batch, device)
    if kind == "dec":
        hd = cfg.resolved_head_dim
        cross = torch.zeros((batch, memory_len, cfg.num_kv_heads, hd),
                            dtype=layers.dtype_of(cfg), device=device)
        return {"self": attention.init_gqa_cache(cfg, batch, max_len,
                                                 rolling, device),
                "cross_k": cross, "cross_v": cross.clone()}
    raise ValueError(kind)


def apply_layer_step(cfg: ModelConfig, kind: str, p: Params, cache: Params,
                     x_t: torch.Tensor, *, rolling: bool = False, lay=None
                     ) -> tuple[torch.Tensor, Params]:
    """One token through one layer.  Attention caches are written in place
    (the returned cache holds the same tensors); recurrent states come back
    as new tensors."""
    def mlp(sub, x):
        return layers.apply_mlp(cfg, sub["mlp"],
                                layers.apply_norm(cfg, sub["norm2"], x))

    if kind in ("attn_mlp", "attn_moe"):
        h_in = layers.apply_norm(cfg, p["norm1"], x_t)
        if cfg.mla is not None:
            h, cache = attention.mla_decode_step(cfg, p["attn"], cache, h_in)
        else:
            h, cache = attention.gqa_decode_step(cfg, p["attn"], cache, h_in,
                                                 rolling=rolling)
        x_t = x_t + h
        if kind == "attn_mlp":
            return x_t + mlp(p, x_t), cache
        h, _ = moe_lib.apply_moe(cfg, p["moe"],
                                 layers.apply_norm(cfg, p["norm2"], x_t),
                                 lay)
        return x_t + h, cache
    if kind == "ssm":
        h_in = layers.apply_norm(cfg, p["norm"], x_t)
        h, cache = ssm.ssm_decode_step(cfg, p["mixer"], cache, h_in)
        return x_t + h, cache
    if kind == "hybrid":
        new_c: Params = {}
        for i, blk in enumerate(cfg.hybrid.pattern):
            sub = p[f"blk{i}"]
            h_in = layers.apply_norm(cfg, sub["norm1"], x_t)
            if blk == "rglru":
                h, new_c[f"blk{i}"] = rglru.rglru_block_step(
                    cfg, sub["rg"], cache[f"blk{i}"], h_in)
            else:
                h, new_c[f"blk{i}"] = attention.gqa_decode_step(
                    cfg, sub["attn"], cache[f"blk{i}"], h_in, rolling=True)
            x_t = x_t + h
            x_t = x_t + mlp(sub, x_t)
        return x_t, new_c
    if kind == "rglru_mlp":
        h_in = layers.apply_norm(cfg, p["norm1"], x_t)
        h, cache = rglru.rglru_block_step(cfg, p["rg"], cache, h_in)
        x_t = x_t + h
        return x_t + mlp(p, x_t), cache
    if kind == "dec":
        h_in = layers.apply_norm(cfg, p["norm1"], x_t)
        h, self_c = attention.gqa_decode_step(cfg, p["attn"], cache["self"],
                                              h_in, rolling=rolling)
        x_t = x_t + h
        # cross-attention against the precomputed memory k/v (no q bias,
        # as in the reference's step)
        h_in = layers.apply_norm(cfg, p["norm_x"], x_t)
        b = x_t.shape[0]
        q = (h_in @ p["cross"]["q"]).reshape(b, 1, cfg.num_heads,
                                             cfg.resolved_head_dim)
        h = attention._sdpa(q, cache["cross_k"], cache["cross_v"], None)
        x_t = x_t + h.reshape(b, 1, -1) @ p["cross"]["o"]
        return x_t + mlp(p, x_t), {"self": self_c,
                                   "cross_k": cache["cross_k"],
                                   "cross_v": cache["cross_v"]}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stacked-segment init / forward / decode
# ---------------------------------------------------------------------------

def init_stack(cfg: ModelConfig, gen: torch.Generator,
               keep: Optional[Callable] = None) -> Params:
    """Every segment's stacked layers; ``keep(tree, path, count)`` (a
    rank's slices, ``partition.slicer``) is applied to each layer as it is
    drawn."""
    return {seg.kind: _stacked(
        lambda kind=seg.kind: init_layer(cfg, kind, gen), seg.count,
        None if keep is None else
        lambda tree, kind=seg.kind, n=seg.count: keep(tree, ("stack", kind),
                                                      n))
        for seg in arch_segments(cfg)}


def apply_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                window: Optional[int] = None,
                memory: Optional[torch.Tensor] = None,
                use_kernel: bool = False,
                only_kinds: Optional[tuple[str, ...]] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run each segment's stacked layers in order. Returns (x, total_aux).

    With ``cfg.remat`` and gradients enabled each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    scan body): only its input is kept, and the backward pass runs it
    again.  Without gradients nothing changes."""
    remat = cfg.remat and torch.is_grad_enabled()
    kw = {"window": window, "memory": memory, "use_kernel": use_kernel}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in arch_segments(cfg):
        if only_kinds is not None and seg.kind not in only_kinds:
            continue
        for p in _layers(params[seg.kind], seg.count):
            if remat:
                x, aux = checkpoint(apply_layer, cfg, seg.kind, p, x,
                                    use_reentrant=False,
                                    preserve_rng_state=False, **kw)
            else:
                x, aux = apply_layer(cfg, seg.kind, p, x, **kw)
            aux_total = aux_total + aux
    return x, aux_total


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     rolling: bool, memory_len: int = 0,
                     device: torch.device | None = None) -> Params:
    """Every decoding segment's caches, stacked; the encoder has none."""
    caches: Params = {}
    for seg in arch_segments(cfg):
        if seg.kind == "enc":
            continue
        one = init_layer_cache(cfg, seg.kind, batch, max_len, rolling,
                               memory_len, device)
        caches[seg.kind] = tree_map(
            lambda leaf, n=seg.count: leaf.expand((n,) + leaf.shape).clone(),
            one)
    return caches


def decode_stack(cfg: ModelConfig, params: Params, caches: Params,
                 x_t: torch.Tensor, *, rolling: bool = False
                 ) -> tuple[torch.Tensor, Params]:
    """One token through every layer.  Each layer's new cache is written
    over its slot of ``caches`` in place (attention caches are written
    there by the step itself), so the stacked state is not copied once per
    token; the same (updated) ``caches`` are returned."""
    def put(slot, leaf):
        if leaf is not slot:
            slot.copy_(leaf)

    for seg in arch_segments(cfg):
        if seg.kind == "enc":
            continue
        for i in range(seg.count):
            old = _layer(caches[seg.kind], i)
            x_t, new = apply_layer_step(
                cfg, seg.kind, _layer(params[seg.kind], i), old, x_t,
                rolling=rolling)
            tree_map2(put, old, new)
    return x_t, caches


# ---------------------------------------------------------------------------
# over the ranks of a data × model mesh (sharding.hints)
# ---------------------------------------------------------------------------

def split_arch(cfg: ModelConfig, nm: int) -> bool:
    """Whether the layers run split over ``nm`` model ranks, each on its
    own heads or channels: the GQA attention stacks (``attn_mlp`` /
    ``attn_moe``, the vision prefix's decoder; ``gqa_forward_ranks`` picks
    heads or context), MLA where nm divides the heads, the Mamba-2 ``ssm``
    stack where its heads and B / C groups split (``ssm.heads_split``),
    the RG-LRU hybrid where nm divides the recurrence's width and the
    MLP's hidden width (its local attention by heads or context), and the
    encoder-decoder where nm divides its query and KV heads.  Where it
    does not, the arch gathers each layer whole and runs it on every rank
    (``gather_layer(whole=True)``), the residual whole along ``model``:
    in the forward, in a decode step and in training alike."""
    if cfg.mla is not None:
        return cfg.num_heads % nm == 0
    if cfg.arch_type == "ssm":
        return ssm.heads_split(cfg, nm)
    if cfg.hybrid is not None:
        return rglru.channels_split(cfg, nm) and cfg.d_ff % nm == 0
    if cfg.is_encoder_decoder:
        return cfg.num_heads % nm == 0 and cfg.num_kv_heads % nm == 0
    return True


def layer_specs(specs):
    """A stacked segment's specs without the layer dim."""
    return tree_map(lambda spec: spec[1:], specs)


def gather_layer(p: Params, specs, lay, whole: bool) -> Params:
    """A layer's slices all-gathered over the data axes (the FSDP leg);
    with ``whole`` over every axis, except the routed experts, which keep
    their slice of ``model`` (the all-to-all dispatch runs on it).  Every
    rank then runs the whole layer alike, so under gradients the
    ``model`` all-gather takes this rank's slice of the (whole, equal)
    gradient back and sums nothing; the data axes' all-gathers sum the
    data ranks' gradients (each ran its own rows)."""
    mesh, comm = lay.mesh, lay.comm
    data = hints.DATA_AXES

    def go(tree, spec, path=()):
        if isinstance(tree, dict):
            return {k: go(tree[k], spec[k], path + (k,)) for k in tree}
        experts = len(path) >= 2 and path[-2] == "moe" \
            and path[-1] in moe_lib.EXPERTS
        x = partition.gather_leaf(tree, spec, mesh, comm, data)
        if not whole or experts:
            return x
        return partition.gather_leaf(x, spec, mesh, comm, ("model",),
                                     "slice")
    return go(p, specs)


def apply_stack_ranks(cfg: ModelConfig, params: Params, specs, x, lay, *,
                      window: Optional[int] = None,
                      memory: Optional[torch.Tensor] = None,
                      use_kernel: bool = False,
                      only_kinds: Optional[tuple[str, ...]] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``apply_stack`` on one rank: ``params`` its slices (``specs`` their
    ``param_specs``), ``x`` its piece of the residual (``lay``).

    With ``cfg.remat`` and gradients enabled each layer — its gathers and
    every collective in it included — runs under ``torch.utils.
    checkpoint`` (non-reentrant): the backward pass runs it again, in a
    copy of the context the layer ran in (the hints are context
    variables, and a card's backward pass runs on another thread), and
    every rank issues the recompute's collectives in the same order."""
    split = split_arch(cfg, lay.nm)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(kind, sp, p, x):
        p = gather_layer(p, sp, lay, whole=not split)
        if split:
            return apply_layer_ranks(cfg, kind, p, x, lay, window=window,
                                     memory=memory, use_kernel=use_kernel)
        return apply_layer(cfg, kind, p, x, window=window, memory=memory,
                           use_kernel=use_kernel, lay=lay)

    for seg in arch_segments(cfg):
        if only_kinds is not None and seg.kind not in only_kinds:
            continue
        sp = layer_specs(specs[seg.kind])
        for p in _layers(params[seg.kind], seg.count):
            if remat:
                # the recompute runs in the backward pass, on the card's
                # autograd thread: it reads the hints as this call saw them
                x, aux = checkpoint(contextvars.copy_context().run, run,
                                    seg.kind, sp, p, x, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = run(seg.kind, sp, p, x)
            aux_total = aux_total + aux
    return x, aux_total


def apply_layer_ranks(cfg: ModelConfig, kind: str, p: Params,
                      x: torch.Tensor, lay, *, window: Optional[int] = None,
                      memory: Optional[torch.Tensor] = None,
                      use_kernel: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A split layer on this rank's piece: ``attn_mlp`` / ``attn_moe``
    (GQA or MLA), ``ssm``, ``hybrid`` / ``rglru_mlp`` (the RG-LRU on the
    rank's channels, the local attention by ``hints.qkv_layout``), ``enc``
    (bidirectional) and ``dec`` (``memory``: the encoder's output whole
    along ``model``, its cross-attention on the rank's heads)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def mlp(sub, x):
        return x + layers.apply_mlp_ranks(
            cfg, sub["mlp"], layers.apply_norm(cfg, sub["norm2"], x), lay,
            _dense_ff_width(cfg))

    def rg(sub, x):
        return x + rglru.rglru_forward_ranks(
            cfg, sub["rg"], layers.apply_norm(cfg, sub["norm1"], x), lay)

    if kind == "ssm":
        return x + ssm.ssm_forward_ranks(
            cfg, p["mixer"], layers.apply_norm(cfg, p["norm"], x), lay,
            use_kernel=use_kernel), zero
    if kind == "hybrid":
        for i, blk in enumerate(cfg.hybrid.pattern):
            sub = p[f"blk{i}"]
            if blk == "rglru":
                x = rg(sub, x)
            else:
                x = x + attention.gqa_forward_ranks(
                    cfg, sub["attn"], layers.apply_norm(cfg, sub["norm1"], x),
                    lay, window=cfg.hybrid.local_window,
                    use_kernel=use_kernel)
            x = mlp(sub, x)
        return x, zero
    if kind == "rglru_mlp":
        return mlp(p, rg(p, x)), zero
    attn = attention.gqa_forward_ranks if cfg.mla is None \
        else attention.mla_forward_ranks
    kw = {"causal": False} if kind == "enc" else {}
    x = x + attn(cfg, p["attn"], layers.apply_norm(cfg, p["norm1"], x), lay,
                 window=window, use_kernel=use_kernel, **kw)
    if kind == "dec":
        x = x + attention.gqa_cross_forward_ranks(
            cfg, p["cross"], layers.apply_norm(cfg, p["norm_x"], x), memory,
            lay)
    if kind == "attn_moe":
        h, aux = moe_lib.apply_moe(cfg, p["moe"],
                                   layers.apply_norm(cfg, p["norm2"], x), lay)
        return x + h, aux
    return mlp(p, x), zero


def apply_layer_step_ranks(cfg: ModelConfig, kind: str, p: Params,
                           cache: Params, specs, x_t: torch.Tensor, lay, *,
                           rolling: bool = False) -> tuple[torch.Tensor,
                                                           Params]:
    """One token through a split layer on this rank's slices of its
    parameters and of its cache (``specs``: the layer's ``cache_specs``):
    ``x_t`` whole along ``model``.  Attention caches are written in place;
    the recurrent states come back as new tensors (the SSM's the rank's
    slices; the RG-LRU's conv state its channels, h whole)."""
    def mlp(sub, x):
        return x + layers.apply_mlp_ranks(
            cfg, sub["mlp"], layers.apply_norm(cfg, sub["norm2"], x), lay,
            _dense_ff_width(cfg))

    def rg(sub, c, x):
        h, c = rglru.rglru_decode_step_ranks(
            cfg, sub["rg"], c, layers.apply_norm(cfg, sub["norm1"], x), lay)
        return x + h, c

    if kind == "ssm":
        h, cache = ssm.ssm_decode_step_ranks(
            cfg, p["mixer"], cache, specs,
            layers.apply_norm(cfg, p["norm"], x_t), lay)
        return x_t + h, cache
    if kind == "hybrid":
        new_c: Params = {}
        for i, blk in enumerate(cfg.hybrid.pattern):
            sub, key = p[f"blk{i}"], f"blk{i}"
            if blk == "rglru":
                x_t, new_c[key] = rg(sub, cache[key], x_t)
            else:
                h, new_c[key] = attention.gqa_decode_step_ranks(
                    cfg, sub["attn"], cache[key], specs[key],
                    layers.apply_norm(cfg, sub["norm1"], x_t), lay,
                    rolling=True)
                x_t = x_t + h
            x_t = mlp(sub, x_t)
        return x_t, new_c
    if kind == "rglru_mlp":
        x_t, cache = rg(p, cache, x_t)
        return mlp(p, x_t), cache
    h_in = layers.apply_norm(cfg, p["norm1"], x_t)
    if cfg.mla is not None:
        h, _ = attention.mla_decode_step_ranks(cfg, p["attn"], cache, specs,
                                               h_in, lay)
    elif kind == "dec":
        h, _ = attention.gqa_decode_step_ranks(cfg, p["attn"], cache["self"],
                                               specs["self"], h_in, lay,
                                               rolling=rolling)
    else:
        h, _ = attention.gqa_decode_step_ranks(cfg, p["attn"], cache, specs,
                                               h_in, lay, rolling=rolling)
    x_t = x_t + h
    if kind == "dec":
        x_t = x_t + attention.gqa_cross_step_ranks(
            cfg, p["cross"], cache, specs,
            layers.apply_norm(cfg, p["norm_x"], x_t), lay)
    if kind == "attn_moe":
        h, _ = moe_lib.apply_moe(cfg, p["moe"],
                                 layers.apply_norm(cfg, p["norm2"], x_t), lay)
        return x_t + h, cache
    return mlp(p, x_t), cache


def _cache_spec(leaf: torch.Tensor, spec) -> tuple:
    """A layer's cache spec with its batch dim (dim 0 of every leaf of two
    or more dims: ``slot_pos`` has none) left out: the rank's rows stay
    its own."""
    return (None,) + tuple(spec[1:]) if leaf.dim() >= 2 else tuple(spec)


def _whole_cache(cache: Params, specs, lay, axes=None) -> Params:
    """A layer's cache slices all-gathered along ``axes`` (every axis by
    default) on every dim but the batch."""
    if isinstance(cache, dict):
        return {k: _whole_cache(cache[k], specs[k], lay, axes)
                for k in cache}
    return partition.gather_leaf(cache, _cache_spec(cache, specs), lay.mesh,
                                 lay.comm, axes)


def _write_back(old: Params, new: Params, specs, lay, axes=None) -> None:
    """This rank's slices (along ``axes``) of a layer's new cache over its
    old ones."""
    if isinstance(old, dict):
        for k in old:
            _write_back(old[k], new[k], specs[k], lay, axes)
        return
    if new is old:
        return
    spec = _cache_spec(old, specs)
    if axes is not None:
        spec = partition.drop_axes(spec, [a for e in spec for a in
                                          partition.entry_axes(e)
                                          if a not in axes])
    old.copy_(partition.local_slice(new, spec, lay.mesh))


def decode_stack_ranks(cfg: ModelConfig, params: Params, specs,
                       caches: Params, cache_specs, x_t: torch.Tensor, lay,
                       *, rolling: bool = False
                       ) -> tuple[torch.Tensor, Params]:
    """``decode_stack`` on one rank: its slices of the parameters and of
    the caches (``cache_specs``), written in place; ``x_t`` its rows of
    the token's residual, whole along ``model``."""
    split = split_arch(cfg, lay.nm)
    for seg in arch_segments(cfg):
        if seg.kind == "enc":
            continue
        sp = layer_specs(specs[seg.kind])
        cs = layer_specs(cache_specs[seg.kind])
        for i in range(seg.count):
            p = gather_layer(_layer(params[seg.kind], i), sp, lay,
                             whole=not split)
            old = _layer(caches[seg.kind], i)
            if split:
                x_t, new = apply_layer_step_ranks(
                    cfg, seg.kind, p, _whole_cache(old, cs, lay,
                                                   hints.DATA_AXES),
                    cs, x_t, lay, rolling=rolling)
                _write_back(old, new, cs, lay, hints.DATA_AXES)
                continue
            x_t, new = apply_layer_step(cfg, seg.kind, p,
                                        _whole_cache(old, cs, lay), x_t,
                                        rolling=rolling, lay=lay)
            _write_back(old, new, cs, lay)
    return x_t, caches
