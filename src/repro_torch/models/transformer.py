"""Stacks of layers for the port: the segment plan of every architecture,
and the ``ssm`` (Mamba-2) segment kind.

The port of src/repro/models/transformer.py.  A model is a list of
segments (kind, count); each segment's per-layer parameters are stacked
along a leading ``count`` axis, as in the reference, so parameters convert
leaf for leaf.  The reference's ``lax.scan`` over that axis is a Python
loop over index 0 of each stacked leaf here.  Its ``hints.hint_residual``
is left out: it only places the residual stream on a device mesh, and with
no mesh it does nothing.

Only the ``ssm`` kind is ported.  The others (``attn_mlp``, ``attn_moe``,
``hybrid``, ``rglru_mlp``, ``enc``, ``dec``) raise NotImplementedError
naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, ssm
from repro_torch.models.layers import Params

KINDS = ("attn_mlp", "attn_moe", "ssm", "hybrid", "rglru_mlp", "enc", "dec")
_NOT_PORTED = ("ROADMAP queue A item 1 (attention families: attention, MoE, "
               "RG-LRU and encoder-decoder forward and decode)")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)
    if kind != "ssm":
        raise NotImplementedError(f"segment kind {kind!r} is not ported to "
                                  f"repro_torch yet: {_NOT_PORTED}")


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


def _stack(trees: list):
    """Leaf-wise ``torch.stack`` of equal-shaped trees (a new leading
    layer axis)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    return tree_map(lambda leaf: leaf[i], tree)


# ---------------------------------------------------------------------------
# per layer: init, forward (full sequence), cache, decode step
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, kind: str, gen: torch.Generator) -> Params:
    _check_kind(kind)
    return {
        "norm": layers.init_norm(cfg, cfg.d_model, gen.device),
        "mixer": ssm.init_ssm(cfg, gen),
    }


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, *,
                window: Optional[int] = None,
                use_kernel: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + ssm.ssm_forward(cfg, p["mixer"],
                            layers.apply_norm(cfg, p["norm"], x),
                            use_kernel=use_kernel)
    return x, aux


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     rolling: bool, device: torch.device | None = None
                     ) -> Params:
    _check_kind(kind)
    return ssm.init_ssm_cache(cfg, batch, device)


def apply_layer_step(cfg: ModelConfig, kind: str, p: Params, cache: Params,
                     x_t: torch.Tensor, *, rolling: bool = False
                     ) -> tuple[torch.Tensor, Params]:
    _check_kind(kind)
    h_in = layers.apply_norm(cfg, p["norm"], x_t)
    h, cache = ssm.ssm_decode_step(cfg, p["mixer"], cache, h_in)
    return x_t + h, cache


# ---------------------------------------------------------------------------
# stacked-segment init / forward / decode
# ---------------------------------------------------------------------------

def init_stack(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {seg.kind: _stack([init_layer(cfg, seg.kind, gen)
                              for _ in range(seg.count)])
            for seg in arch_segments(cfg)}


def apply_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                window: Optional[int] = None,
                use_kernel: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run each segment's stacked layers in order. Returns (x, total_aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in arch_segments(cfg):
        for i in range(seg.count):
            x, aux = apply_layer(cfg, seg.kind, _layer(params[seg.kind], i),
                                 x, window=window, use_kernel=use_kernel)
            aux_total = aux_total + aux
    return x, aux_total


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     rolling: bool, device: torch.device | None = None
                     ) -> Params:
    caches: Params = {}
    for seg in arch_segments(cfg):
        one = init_layer_cache(cfg, seg.kind, batch, max_len, rolling, device)
        caches[seg.kind] = tree_map(
            lambda leaf, n=seg.count: leaf.new_zeros((n,) + leaf.shape), one)
    return caches


def decode_stack(cfg: ModelConfig, params: Params, caches: Params,
                 x_t: torch.Tensor, *, rolling: bool = False
                 ) -> tuple[torch.Tensor, Params]:
    """One token through every layer.  Each layer's new cache is written
    over its slot of ``caches`` in place, so the stacked state is not copied
    once per token; the same (updated) ``caches`` are returned."""
    for seg in arch_segments(cfg):
        for i in range(seg.count):
            old = _layer(caches[seg.kind], i)
            x_t, new = apply_layer_step(
                cfg, seg.kind, _layer(params[seg.kind], i), old, x_t,
                rolling=rolling)
            tree_map2(lambda slot, leaf: slot.copy_(leaf), old, new)
    return x_t, caches
