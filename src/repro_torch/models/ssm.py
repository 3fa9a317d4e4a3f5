"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

The port of src/repro/models/ssm.py.  Chunked SSD: within a chunk the
recurrence is a dense product with a decay-weighted score matrix, and the
states are carried across chunks — the paper's "dual" form.
``ssm_forward(use_kernel=True)`` runs the scan through ``kernels.ops.
ssd_scan`` (the hand-written CUDA kernel on the card, its plain version on
the CPU); otherwise ``ssd_chunked`` below, the plain tensor form.

Block layout (simplified Mamba-2):
  in_proj  : D -> [z (d_in), x (d_in), B (G·N), C (G·N), dt (H)]
  conv1d   : causal depthwise over [x, B, C]
  SSD      : h_t = exp(dt·A) h_{t-1} + dt·B_t ⊗ x_t ;  y_t = C_t · h_t
  out      : y · silu(z)  -> out_proj

The dtypes follow the reference: projections, conv and the C·Bᵀ scores in
the config's dtype, dt, the decays and the carried state in f32.  Where two
operands of different dtypes meet in an einsum, both go to the promoted
dtype first, as JAX promotes them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, dtype_of


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    dtype = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dtype) for o in ops))


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return d_in, n_heads, s.n_groups, s.d_state


def init_ssm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    s = cfg.ssm
    dt = dtype_of(cfg)
    d_in, h, g, n = dims(cfg)
    f32 = dict(dtype=torch.float32, device=gen.device)
    proj_out = 2 * d_in + 2 * g * n + h
    return {
        "in_proj": dense_init(gen, (cfg.d_model, proj_out), dt),
        "conv": layers.init_conv(cfg, gen, d_in + 2 * g * n, s.conv_kernel),
        "a_log": torch.zeros((h,), **f32),       # A = -exp(a_log) ∈ (-∞,0)
        "dt_bias": torch.full((h,), -2.0, **f32),  # softplus ≈ 0.12
        "d_skip": torch.ones((h,), **f32),
        "out_proj": dense_init(gen, (d_in, cfg.d_model), dt),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, h, g, n = dims(cfg)
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * g * n, h], dim=-1)
    return z, xbc, dt_raw


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_in, h, g, n = dims(cfg)
    x, b_mat, c_mat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    return x, b_mat, c_mat


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:     (B, S, H, P)   per-head inputs
    dt:    (B, S, H)      softplus-ed timestep
    a:     (H,)           negative decay rate (A = -exp(a_log))
    b_mat: (B, S, G, N)   input projections  (G groups broadcast over H)
    c_mat: (B, S, G, N)   output projections
    h0:    (B, H, P, N)   initial state (decode/resume)
    returns (y (B,S,H,P), h_final (B,H,P,N) f32)

    ``chunk`` must divide S, as the reference asserts.  At (B, S, H) =
    (4, 4096, 64) and chunk 256 the (B, NC, L, L, H) f32 scores take 1.07
    GB; they are freed when the call returns.
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence "
                         f"length {s}")
    nc = s // chunk

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = c_mat.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da = dtc * a                                   # (B,NC,L,H) log-decay
    cum = torch.cumsum(da, dim=2)                  # within-chunk cumulative

    # intra-chunk (dual / attention-like) term:
    #   scores[t, u] = C_t · B_u · exp(cum_t − cum_u) · dt_u,  u ≤ t
    li = torch.arange(chunk, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    # the exponent is masked before exp, as well as the decay after it:
    # above the diagonal cum_t − cum_u > 0 overflows exp once a chunk's
    # Σ dt·|a| passes ~88, and the masked where's zero gradient times
    # exp's inf is NaN (the reference masks only the decay).  Below it
    # the values are the same bits.
    seg = torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :],
                      0.0)
    decay = torch.where(causal, torch.exp(seg), 0.0)
    del seg
    scores = _einsum("bclhn,bcuhn->bcluh", cc, bc) * decay  # (B,NC,L,U,H)
    del decay
    scores = scores * dtc[:, :, None, :, :]        # weight by dt_u
    y_intra = _einsum("bcluh,bcuhp->bclhp", scores, xc)
    del scores

    # chunk-final states: h_c = Σ_u exp(cum_L − cum_u)·dt_u · B_u ⊗ x_u
    w_state = torch.exp(cum[:, :, -1:, :] - cum) * dtc    # (B,NC,L,H)
    states = _einsum("bclh,bclhn,bclhp->bchpn", w_state, bc, xc).float()

    # inter-chunk recurrence over chunk-level decays (f32 carry)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,NC,H)
    h_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
              if h0 is None else h0.float())
    h_prevs = []                                          # state BEFORE c
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,NC,H,P,N)

    # contribution of the carried-in state to each position
    y_inter = _einsum("bclhn,bchpn,bclh->bclhp", cc, h_prevs, torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, h_prev


def ssm_forward(cfg: ModelConfig, p: Params, xin: torch.Tensor,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence mixer forward: (B, S, D) -> (B, S, D)."""
    s_cfg = cfg.ssm
    d_in, h, g, n = dims(cfg)
    bsz, s, _ = xin.shape
    proj = xin @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = layers.apply_conv(p["conv"], xbc)
    xbc = F.silu(xbc)
    x, b_mat, c_mat = _split_xbc(cfg, xbc)

    x = x.reshape(bsz, s, h, s_cfg.head_dim)
    b_mat = b_mat.reshape(bsz, s, g, n)
    c_mat = c_mat.reshape(bsz, s, g, n)
    dt = layers.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if use_kernel:
        from repro_torch.kernels import ops as kops
        y, _ = kops.ssd_scan(x, dt, a, b_mat, c_mat, chunk=s_cfg.chunk_size)
    else:
        chunk = min(s_cfg.chunk_size, s)
        y, _ = ssd_chunked(x, dt, a, b_mat, c_mat, chunk)
    y = y + x * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, s, d_in).to(xin.dtype) * F.silu(z)
    return (y @ p["out_proj"]).to(xin.dtype)


# ---------------------------------------------------------------------------
# decode: single-token recurrence against carried (conv, ssm) state
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: torch.device) -> Params:
    s = cfg.ssm
    d_in, h, g, n = dims(cfg)
    dt = dict(dtype=dtype_of(cfg), device=device)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, d_in + 2 * g * n),
                            **dt),
        "h": torch.zeros((batch, h, s.head_dim, n), **dt),
    }


def ssm_decode_step(cfg: ModelConfig, p: Params, cache: Params,
                    x_t: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """x_t: (B, 1, D) -> (B, 1, D); O(1) state update (the SSM advantage).
    The carried state stays in the config's dtype, as in the reference."""
    s_cfg = cfg.ssm
    d_in, h, g, n = dims(cfg)
    bsz = x_t.shape[0]
    proj = x_t[:, 0, :] @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = layers.apply_conv_step(p["conv"], cache["conv"], xbc)
    xbc = F.silu(xbc)
    x, b_mat, c_mat = _split_xbc(cfg, xbc)

    x = x.reshape(bsz, h, s_cfg.head_dim)
    b_mat = b_mat.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)
    c_mat = c_mat.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)
    dt = layers.softplus(dt_raw.float() + p["dt_bias"])
    decay = torch.exp(dt * -torch.exp(p["a_log"]))          # (B, H)

    h_new = cache["h"] * decay[:, :, None, None].to(x.dtype) + \
        _einsum("bhp,bhn,bh->bhpn", x, b_mat, dt.to(x.dtype))
    y = _einsum("bhn,bhpn->bhp", c_mat, h_new)
    y = y + x * p["d_skip"][None, :, None].to(x.dtype)
    y = y.reshape(bsz, d_in) * F.silu(z)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": conv_state, "h": h_new}
