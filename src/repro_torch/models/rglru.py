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
