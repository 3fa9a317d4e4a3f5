"""Shared layer primitives: dtypes, the truncated-normal init, norms,
gated and ungated MLPs, RoPE, embeddings and the depthwise causal conv.

Counterparts of the same names in src/repro/models/layers.py, in the same
functional style: ``init_*`` builds a dict of tensors, ``apply_*`` consumes
it.  Parameters live in the config dtype (bf16 for the published
architectures); norm statistics and rotary math run in f32 and the
unembedding gives f32 logits.

Over the ranks of a data × model mesh (``sharding.hints.RankLayout``) a
rank holds its slices by ``param_specs``: ``embed_ranks`` looks up the
ids among its rows of the vocabulary-split table and sums over ``model``
(exact: one term is non-zero); ``unembed`` on its slice of the table (or
of ``unembed``) gives its vocabulary columns of the logits; and
``apply_mlp_ranks`` runs up / gate column-split and down row-split, then
one sum over ``model`` laid out as the residual; ``next_token_ce_ranks``
is the training loss on the rank's logits block (the vocabulary-parallel
cross-entropy, ``vocab_parallel_nll``).  All of them carry gradients
(``sharding.hints``' conventions).
"""
from __future__ import annotations

import math
import weakref
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the standard normal's CDF at -2 and 2: the truncated normal's range
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """``scale`` (default 1/√fan_in) times a standard normal truncated to
    [-2, 2], drawn in f32 on the generator's device by inverting the CDF:
    the reference's distribution, not its numbers."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=torch.float32)
    u = _CDF_LO + (_CDF_HI - _CDF_LO) * u
    z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (scale * z).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dim: int, device: torch.device) -> Params:
    p = {"scale": torch.ones((dim,), dtype=dtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype_of(cfg), device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# MLP variants (swiglu / geglu gated; relu2 = squared ReLU (Nemotron); gelu)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_model: int,
             d_ff: int) -> Params:
    dt = dtype_of(cfg)
    p = {}
    if cfg.mlp in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, (d_model, d_ff), dt)
    p["up"] = dense_init(gen, (d_model, d_ff), dt)
    p["down"] = dense_init(gen, (d_ff, d_model), dt)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: the tanh form."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    elif cfg.mlp == "geglu":
        h = gelu(x @ p["gate"]) * (x @ p["up"])
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(x @ p["up"]))
    else:
        h = gelu(x @ p["up"])
    return h @ p["down"]


def apply_mlp_ranks(cfg: ModelConfig, p: Params, x: torch.Tensor, lay,
                    width: int, entered: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """``apply_mlp`` on this rank's piece ``x`` of the residual with its
    slices of an MLP of hidden ``width``: where the hidden dim is split
    over ``model``, the residual whole (``lay.enter``, or ``entered`` where
    the caller has it already), the rank's hidden columns, and the partial
    products summed over ``model`` (``lay.leave``); otherwise the whole MLP
    on the piece."""
    if p["up"].shape[-1] == width:
        return apply_mlp(cfg, p, x)
    return lay.leave(apply_mlp(cfg, p, lay.enter(x) if entered is None
                               else lay.fork(entered)))


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs     # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]             # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = dtype_of(cfg)
    p = {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                             scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def embed_ranks(cfg: ModelConfig, p: Params, tokens: torch.Tensor, lay,
                prefix: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's piece of the embedded residual: the ids of its rows
    (``tokens``, (B, S)) looked up among its rows of the table, zero
    outside them, and summed over ``model`` into the residual's layout;
    ``prefix`` (B, P, D), the same on every rank (the vision prefix), goes
    before the tokens (the first model rank adds it to the sum)."""
    table = p["table"]
    if table.shape[0] == cfg.vocab_size:
        x = embed(p, tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return lay.piece(x)
    n = table.shape[0]
    ids = tokens.long() - lay.m * n
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    if prefix is not None:
        prefix = prefix.to(rows.dtype)
        rows = torch.cat([prefix if lay.m == 0 else torch.zeros_like(prefix),
                          rows], dim=1)
    return lay.leave(rows)


# the f32 copy of the last unembedding matrix seen, keyed by a weak reference
# to the parameter and its version counter
_f32_memo: dict = {}


def _f32_weight(w: torch.Tensor) -> torch.Tensor:
    """``w.float()``, made once per parameter rather than on every call: a
    decode step would otherwise copy the whole (V, D) table each token.  A
    parameter that needs gradients, or one written since (where its version
    is tracked: not for inference tensors), gets a fresh copy."""
    if w.dtype == torch.float32 or w.requires_grad:
        return w.float()
    version = None if w.is_inference() else w._version
    ref, seen, copy = _f32_memo.get("w", (None, None, None))
    if ref is None or ref() is not w or seen != version:
        copy = w.float()

        def drop(r):
            if _f32_memo.get("w", (None,))[0] is r:
                _f32_memo.clear()
        _f32_memo["w"] = (weakref.ref(w, drop), version, copy)
    return copy


def f32_copy_bytes() -> int:
    """The bytes of the f32 unembedding copy ``_f32_weight`` holds now."""
    held = _f32_memo.get("w")
    return 0 if held is None else held[2].numel() * 4


def unembed(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """f32 logits, as the reference's ``preferred_element_type=f32``: the
    operands go up to f32 before the product (a bf16 ``matmul`` would round
    its output to bf16); products of bf16 values are exact in f32."""
    if cfg.tie_embeddings:
        return torch.matmul(x.float(), _f32_weight(p["table"]).t())
    return torch.matmul(x.float(), _f32_weight(p["unembed"]))


def next_token_nll(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """−log softmax(logits)[target] per position, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


class _ExpSumAt(torch.autograd.Function):
    """With z = logits − ``top`` (the row maxima): (Σ exp(z) over the last
    dim, z at ``idx`` where ``inside`` else 0), stacked.  exp(z) is formed
    in z's buffer, and the backward writes exp(z) · g₀ into one buffer and
    adds g₁ at ``idx`` in place: the bits autograd's sub / exp / gather /
    where chain gives (each element's one product and, at the target, one
    sum), with one (B, S, V/nm) buffer live beside the logits, not three."""

    @staticmethod
    def forward(ctx, logits, top, idx, inside):
        z = logits - top[..., None]
        zt = torch.gather(z, -1, idx[..., None])[..., 0]
        zt = torch.where(inside, zt, torch.zeros((), dtype=z.dtype,
                                                 device=z.device))
        e = z.exp_()
        ctx.save_for_backward(e, idx, inside)
        return torch.stack([e.sum(-1), zt])

    @staticmethod
    def backward(ctx, g):
        e, idx, inside = ctx.saved_tensors
        grad = e * g[0][..., None]
        at = torch.where(inside, g[1], torch.zeros((), dtype=g.dtype,
                                                   device=g.device))
        return grad.scatter_add_(-1, idx[..., None], at[..., None]), None, \
            None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       lay) -> torch.Tensor:
    """``next_token_nll`` of the whole vocabulary from this rank's block of
    the logits (B, S, V/nm: columns ``lay.m · V/nm`` on, f32), without
    gathering the (B, S, V) logits: the row maxima's max over ``model``
    (no gradient: the shift cancels), Σ exp over the rank's columns and
    the target's logit from the rank that owns its column (zero on the
    others) summed over ``model`` in rank order, and log Σ − target.  The
    backward is softmax − one-hot on the rank's own columns (the sum's
    gradient passes on), formed in one buffer (``_ExpSumAt``)."""
    comm, n = lay.comm, logits.shape[-1]
    with torch.no_grad():
        top = torch.stack(comm.model_parts(logits.amax(-1))).amax(0)
    t = targets.long() - lay.m * n
    inside = (t >= 0) & (t < n)
    sums = comm.sum_model(_ExpSumAt.apply(logits, top, t.clamp(0, n - 1),
                                          inside))
    return torch.log(sums[0]) - sums[1]


def next_token_ce_ranks(cfg: ModelConfig, p: Params, h: torch.Tensor,
                        targets: torch.Tensor, lay, shift: int = 0,
                        prefix: int = 0) -> torch.Tensor:
    """The mean next-token cross-entropy of this rank's rows over ranks:
    ``h`` its piece of the final hidden (``lay``), ``targets`` (B, S) its
    rows' whole, ``p`` its slice of the embedding; with ``shift``,
    position t against target t + ``shift`` (the last ``shift`` positions
    dropped: multi-token prediction); with ``prefix``, the hidden's first
    ``prefix`` positions (the vision prefix) carry no target.  With the
    vocabulary split over ``model``, ``h`` whole along ``model`` and the
    vocabulary-parallel CE on the rank's logits block; else the whole
    vocabulary on the rank's positions (their shifted targets may lie in
    the next rank's piece), their sums added over ``model``."""
    table = p["table"] if cfg.tie_embeddings else p["unembed"]
    b, s = targets.shape
    if table.shape[0 if cfg.tie_embeddings else 1] != cfg.vocab_size:
        hw = lay.enter(h)[:, prefix:]
        return vocab_parallel_nll(unembed(cfg, p, hw[:, :s - shift]),
                                  targets[:, shift:], lay).mean()
    if not lay.seq_split:
        return next_token_nll(unembed(cfg, p, h[:, prefix:prefix + s - shift]),
                              targets[:, shift:]).mean()
    ahead = torch.cat([targets.new_zeros((b, prefix)), targets[:, shift:],
                       targets[:, :shift]], 1)
    nll = next_token_nll(unembed(cfg, p, h), lay.piece(ahead))
    rows = lay.positions
    pos = torch.arange(rows.start, rows.stop, device=nll.device)
    keep = (pos >= prefix) & (pos < prefix + s - shift)
    nll = torch.where(keep, nll, torch.zeros((), dtype=nll.dtype,
                                             device=nll.device))
    return lay.comm.sum_model(nll.sum()) / (b * (s - shift))


# ---------------------------------------------------------------------------
# depthwise causal conv (mamba2 / RG-LRU blocks) with streaming state
# ---------------------------------------------------------------------------

def init_conv(cfg: ModelConfig, gen: torch.Generator, width: int,
              kernel: int) -> Params:
    dt = dtype_of(cfg)
    return {"w": dense_init(gen, (kernel, width), dt, scale=0.5),
            "b": torch.zeros((width,), dtype=dt, device=gen.device)}


def apply_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, W)."""
    k = p["w"].shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * p["w"][i] for i in range(k))
    return out + p["b"]


def apply_conv_step(p: Params, state: torch.Tensor, x_t: torch.Tensor):
    """One decode step. state: (B, k-1, W) past inputs; x_t: (B, W)."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)     # (B, k, W)
    out = torch.einsum("bkw,kw->bw", window, p["w"]) + p["b"]
    return out, window[:, 1:, :]
