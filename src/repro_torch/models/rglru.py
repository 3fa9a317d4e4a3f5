"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of src/repro/models/rglru.py.  Recurrent block: two input
branches (gate: GeLU; signal: conv1d → RG-LRU), elementwise merge, output
projection.  RG-LRU:

    r_t = σ(W_a x_t + b_a)            recurrence gate (block-diagonal W)
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(−c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The sequence form is a log-depth doubling scan over the reference's
``combine`` (its ``lax.associative_scan``): ⌈log2 S⌉ rounds of whole-tensor
ops, never a loop over the S tokens.  Both reassociate the recurrence, so
they agree to rounding.  Decode is the O(1) per-token recurrence.

Over the ranks of a data × model mesh (``rglru_forward_ranks``,
``rglru_decode_step_ranks``) the block is channel-parallel, as
``param_specs`` places it: each rank holds W/nm columns of ``in_x`` /
``in_gate`` and of the conv, the same rows of ``out``, and runs the gates
and the scan on its channels over the whole sequence, with no collective
along the scan.  The block-diagonal gates (8 blocks, replicated) read a
whole block: where nm > 8 a rank's channels are part of one, so the rank
forms the conv output of its blocks' channels (``channel_cut``) and keeps
its own after the gates.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, dtype_of

N_DIAG_BLOCKS = 8


def width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = dtype_of(cfg)
    w = width(cfg)
    bs = w // N_DIAG_BLOCKS
    f32 = dict(dtype=torch.float32, device=gen.device)
    # Λ init so that a ∈ (0.9, 0.999) at r=1 (Griffin appendix)
    lam = torch.log(torch.expm1(-torch.log(
        torch.linspace(0.9, 0.999, w, **f32)) / cfg.hybrid.lru_c))
    return {
        "in_x": dense_init(gen, (cfg.d_model, w), dt),
        "in_gate": dense_init(gen, (cfg.d_model, w), dt),
        "conv": layers.init_conv(cfg, gen, w, cfg.hybrid.conv_kernel),
        "gate_a": dense_init(gen, (N_DIAG_BLOCKS, bs, bs), dt),
        "gate_a_b": torch.zeros((w,), **f32),
        "gate_x": dense_init(gen, (N_DIAG_BLOCKS, bs, bs), dt),
        "gate_x_b": torch.zeros((w,), **f32),
        "lam": lam,
        "out": dense_init(gen, (w, cfg.d_model), dt),
    }


def _block_diag(gate_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., W) through block-diagonal weight (NB, bs, bs)."""
    nb, bs, _ = gate_w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bs))
    return torch.einsum("...nb,nbc->...nc", xb, gate_w).reshape(x.shape)


def _rglru_gates(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """Returns (log_a, scaled_input): h_t = exp(log_a)h + √(1−a²)(i·x)."""
    r = torch.sigmoid(_block_diag(p["gate_a"], x).float() + p["gate_a_b"])
    i = torch.sigmoid(_block_diag(p["gate_x"], x).float() + p["gate_x_b"])
    log_a = -cfg.hybrid.lru_c * layers.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    scaled = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return log_a, scaled


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t from h_{−1} = 0 along dim 1, by doubling:
    after the round of stride d, (a_t, b_t) holds the composition of the
    last 2d steps (the reference's ``combine``: (a1·a2, a2·b1 + b2))."""
    s = a.shape[1]
    for d in (1 << j for j in range(math.ceil(math.log2(max(s, 1))))):
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
    return b


def rglru_scan(cfg: ModelConfig, p: Params, x: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence over (B, S, W): (h in x's dtype, last h in f32)."""
    log_a, scaled = _rglru_gates(cfg, p, x)
    a = torch.exp(log_a)
    if h0 is not None:
        scaled = scaled.clone()
        scaled[:, 0] += a[:, 0] * h0.float()
    h = linear_scan(a, scaled)
    return h.to(x.dtype), h[:, -1]


def rglru_block_forward(cfg: ModelConfig, p: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, D)."""
    gate = layers.gelu(x @ p["in_gate"])
    sig = layers.apply_conv(p["conv"], x @ p["in_x"])
    h, _ = rglru_scan(cfg, p, sig)
    return (h * gate) @ p["out"]


# ---------------------------------------------------------------------------
# over the ranks of a data × model mesh: the rank's channels
# ---------------------------------------------------------------------------

def channels_split(cfg: ModelConfig, nm: int) -> bool:
    """Whether ``param_specs`` splits the block's W channels over nm model
    ranks (W divisible by nm)."""
    w = width(cfg)
    return w % nm == 0 and w >= nm


def channel_cut(cfg: ModelConfig, nm: int, m: int) -> tuple[slice, slice]:
    """Rank ``m``'s channels of the W over nm ranks (``own``) and the
    channels its gates read (``span``: the whole diagonal blocks that
    ``own`` lies in; ``own`` itself where nm divides the 8 blocks)."""
    w = width(cfg)
    n, bs = w // nm, w // N_DIAG_BLOCKS
    own = slice(m * n, (m + 1) * n)
    return own, slice(own.start // bs * bs, -(-own.stop // bs) * bs)


def _gates_on(cfg: ModelConfig, p: Params, sig: torch.Tensor, own: slice,
              span: slice):
    """``_rglru_gates`` of the ``span`` channels ``sig`` (whole blocks),
    kept on the ``own`` channels: (log_a, scaled)."""
    bs = p["gate_a"].shape[-1]
    blocks = slice(span.start // bs, span.stop // bs)
    q = {"gate_a": p["gate_a"][blocks], "gate_x": p["gate_x"][blocks],
         **{k: p[k][span] for k in ("gate_a_b", "gate_x_b", "lam")}}
    log_a, scaled = _rglru_gates(cfg, q, sig)
    keep = slice(own.start - span.start, own.stop - span.start)
    return log_a[..., keep], scaled[..., keep]


def rglru_channels(cfg: ModelConfig, p: Params, x: torch.Tensor, own: slice,
                   span: slice) -> torch.Tensor:
    """A rank's partial ``rglru_block_forward`` of the whole sequence ``x``
    (B, S, D) on its ``own`` channels: ``p`` holds in_x and the conv over
    ``span``'s channels, in_gate over ``own``'s columns, ``out`` over its
    rows, the gates, their biases and Λ whole.  The conv output of
    ``span``'s channels, the gates on their blocks, the scan and the GeLU
    gate on ``own``'s, and its rows of ``out``; the ranks' outputs sum to
    ``rglru_block_forward``'s."""
    gate = layers.gelu(x @ p["in_gate"])
    sig = layers.apply_conv(p["conv"], x @ p["in_x"])
    log_a, scaled = _gates_on(cfg, p, sig, own, span)
    h = linear_scan(torch.exp(log_a), scaled).to(sig.dtype)
    return (h * gate) @ p["out"]


def rglru_forward_ranks(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        lay) -> torch.Tensor:
    """This rank's share of ``rglru_block_forward`` under the hints: ``x``
    its piece of the (normed) residual, ``p`` its shards by
    ``param_specs`` (the data axes gathered: W/nm columns of in_x /
    in_gate / the conv, rows of ``out``); returns its piece of the output.
    The residual whole along ``model`` (``lay.enter``), the rank's
    channels (``rglru_channels``), one sum over ``model`` laid out as the
    residual (``lay.leave``).  Where the rank's gate blocks reach past its
    channels (nm > 8), in_x and the conv are all-gathered along ``model``
    and cut to the blocks' channels."""
    own, span = channel_cut(cfg, lay.nm, lay.m)
    w = width(cfg)
    in_x, conv_w = p["in_x"], p["conv"]["w"]
    if span != own:
        lo, hi = span.start, span.stop
        in_x = lay.whole(in_x, 1, w)[:, lo:hi]
        conv_w = lay.whole(conv_w, 1, w)[:, lo:hi]
    q = {"in_x": in_x, "in_gate": p["in_gate"], "out": p["out"],
         "conv": {"w": conv_w, "b": lay.fork(p["conv"]["b"])[span]},
         **{k: lay.fork(p[k]) for k in ("gate_a", "gate_x", "gate_a_b",
                                        "gate_x_b", "lam")}}
    return lay.leave(rglru_channels(cfg, q, lay.enter(x), own, span))


def init_rglru_cache(cfg: ModelConfig, batch: int,
                     device: torch.device | None = None) -> Params:
    w = width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.hybrid.conv_kernel - 1, w),
                            dtype=dtype_of(cfg), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_block_step(cfg: ModelConfig, p: Params, cache: Params,
                     x_t: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """One decode token: x_t (B, 1, D)."""
    xt = x_t[:, 0, :]
    gate = layers.gelu(xt @ p["in_gate"])
    sig, conv_state = layers.apply_conv_step(p["conv"], cache["conv"],
                                             xt @ p["in_x"])
    log_a, scaled = _rglru_gates(cfg, p, sig)
    h = torch.exp(log_a) * cache["h"] + scaled
    out = ((h.to(xt.dtype) * gate) @ p["out"])[:, None, :]
    return out, {"conv": conv_state, "h": h}


def rglru_step_channels(cfg: ModelConfig, p: Params, conv_state: torch.Tensor,
                        h: torch.Tensor, x_t: torch.Tensor, own: slice,
                        span: slice, join) -> tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]:
    """A rank's partial ``rglru_block_step``: ``p`` as ``rglru_channels``'
    with ``span`` = ``own`` (in_x, in_gate and the conv over its own
    channels, ``out`` over its rows), ``conv_state`` (B, k − 1,
    W/nm) its channels' state, ``h`` (B, W) the whole state; ``join``
    all-gathers a (B, W/nm) tensor along the ranks.  Returns (its partial
    output (B, 1, D), its new conv state, its channels' new h): the conv
    runs on its channels, its outputs are joined where the gates read past
    them (``span``)."""
    xt = x_t[:, 0, :]
    gate = layers.gelu(xt @ p["in_gate"])
    sig, conv_state = layers.apply_conv_step(p["conv"], conv_state,
                                             xt @ p["in_x"])
    if span != own:
        sig = join(sig)[:, span]
    log_a, scaled = _gates_on(cfg, p, sig, own, span)
    h_own = torch.exp(log_a) * h[:, own] + scaled
    return ((h_own.to(xt.dtype) * gate) @ p["out"])[:, None, :], \
        conv_state, h_own


def rglru_decode_step_ranks(cfg: ModelConfig, p: Params, cache: Params,
                            x_t: torch.Tensor, lay
                            ) -> tuple[torch.Tensor, Params]:
    """One token through one rank's share of ``rglru_block_step``:
    ``x_t`` (B, 1, D) whole along ``model``, ``cache`` its slices by
    ``cache_specs`` (the conv state's channels over ``model``; ``h`` whole,
    as the reference's rule never splits it).  The rank advances its
    channels (``rglru_step_channels``), its partial outputs are summed over
    ``model`` and its channels of the new h all-gathered in rank order
    (f32), so every rank holds the same whole h."""
    own, span = channel_cut(cfg, lay.nm, lay.m)
    comm = lay.comm
    p = dict(p, conv={"w": p["conv"]["w"], "b": p["conv"]["b"][own]})
    out, conv_state, h_own = rglru_step_channels(
        cfg, p, cache["conv"], cache["h"], x_t, own, span,
        lambda t: comm.gather_model(t, 1))
    return comm.sum_model(out), {"conv": conv_state,
                                 "h": comm.gather_model(h_own, 1)}
