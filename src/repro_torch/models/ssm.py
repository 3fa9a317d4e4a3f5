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
from repro_torch.sharding import partition


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


# ---------------------------------------------------------------------------
# over the ranks of a data × model mesh: the rank's heads
# ---------------------------------------------------------------------------

def _rank_groups(cfg: ModelConfig, m: int, nm: int):
    """The groups of B / C that rank ``m``'s H/nm heads read, as
    (first, end), or None where they do not line up with the heads (a
    group shared by two ranks' heads unevenly)."""
    _, h, g, _ = dims(cfg)
    if h % nm:
        return None
    nh, rep = h // nm, h // g
    if rep % nh and nh % rep:
        return None
    lo = m * nh // rep
    return lo, max(lo + 1, (m + 1) * nh // rep)


def heads_split(cfg: ModelConfig, nm: int) -> bool:
    """Whether the mixer's heads split over nm model ranks (H divisible
    by nm, B / C groups aligned with them): ``transformer.split_arch``."""
    return _rank_groups(cfg, 0, nm) is not None


def head_columns(cfg: ModelConfig, m: int, nm: int):
    """Rank ``m``'s head-aligned columns as (first, end) ranges: of
    in_proj's [z | x | B | C | dt] (its heads' z, x and dt, its groups' B
    and C: all of them when n_groups = 1) and of the conv's [x | B | C]
    channels.  ``param_specs`` cuts both into contiguous blocks that
    straddle those boundaries; these are the columns the rank's heads
    need."""
    d_in, h, g, n = dims(cfg)
    nh, p = h // nm, cfg.ssm.head_dim
    g_lo, g_hi = _rank_groups(cfg, m, nm)
    xs = (m * nh * p, (m + 1) * nh * p)
    bs = (g_lo * n, g_hi * n)
    proj = [xs, (d_in + xs[0], d_in + xs[1]),
            (2 * d_in + bs[0], 2 * d_in + bs[1]),
            (2 * d_in + g * n + bs[0], 2 * d_in + g * n + bs[1]),
            (2 * d_in + 2 * g * n + m * nh, 2 * d_in + 2 * g * n
             + (m + 1) * nh)]
    conv = [xs, (d_in + bs[0], d_in + bs[1]),
            (d_in + g * n + bs[0], d_in + g * n + bs[1])]
    return proj, conv


def cut(w: torch.Tensor, ranges, dim: int = -1) -> torch.Tensor:
    """The ``ranges`` of ``w`` along ``dim``, joined in order."""
    return torch.cat([w.narrow(dim, a, b - a) for a, b in ranges], dim)


def ssm_heads(cfg: ModelConfig, p: Params, x: torch.Tensor, m: int, nm: int,
              use_kernel: bool = False) -> torch.Tensor:
    """Rank ``m``'s partial ``ssm_forward`` of the whole sequence ``x``
    (B, S, D): ``p`` holds in_proj and the conv whole, ``out_proj`` the
    rank's rows (its heads' d_in / nm), the per-head vectors whole.  The
    product runs on the rank's head-aligned columns only (``head_columns``:
    cut before it), then the conv on its x channels and its B / C
    channels, the scan on its H/nm heads, the skip, the gate and its rows
    of out_proj.  The ranks' outputs sum to ``ssm_forward``'s."""
    s_cfg = cfg.ssm
    d_in, h, g, n = dims(cfg)
    nh, hp = h // nm, s_cfg.head_dim
    g_lo, g_hi = _rank_groups(cfg, m, nm)
    gl = g_hi - g_lo
    bsz, s, _ = x.shape
    proj_cols, conv_cols = head_columns(cfg, m, nm)
    proj = x @ cut(p["in_proj"], proj_cols)
    z, xbc, dt_raw = torch.split(proj, [nh * hp, nh * hp + 2 * gl * n, nh],
                                 dim=-1)
    xbc = F.silu(layers.apply_conv({"w": cut(p["conv"]["w"], conv_cols),
                                    "b": cut(p["conv"]["b"], conv_cols)},
                                   xbc))
    xh, b_mat, c_mat = torch.split(xbc, [nh * hp, gl * n, gl * n], dim=-1)
    xh = xh.reshape(bsz, s, nh, hp)
    b_mat = b_mat.reshape(bsz, s, gl, n)
    c_mat = c_mat.reshape(bsz, s, gl, n)
    heads = slice(m * nh, (m + 1) * nh)
    dt = layers.softplus(dt_raw.float() + p["dt_bias"][heads])
    a = -torch.exp(p["a_log"][heads])
    if use_kernel:
        from repro_torch.kernels import ops as kops
        y, _ = kops.ssd_scan(xh, dt, a, b_mat, c_mat, chunk=s_cfg.chunk_size)
    else:
        y, _ = ssd_chunked(xh, dt, a, b_mat, c_mat, min(s_cfg.chunk_size, s))
    y = y + xh * p["d_skip"][heads][None, None, :, None].to(xh.dtype)
    y = y.reshape(bsz, s, nh * hp).to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"]).to(x.dtype)


def ssm_forward_ranks(cfg: ModelConfig, p: Params, x: torch.Tensor, lay,
                      use_kernel: bool = False) -> torch.Tensor:
    """This rank's share of ``ssm_forward`` under the hints: ``x`` its
    piece of the (normed) residual, ``p`` its shards by ``param_specs``
    (the data axes gathered); returns its piece of the output.

    The rank runs its H/nm heads (``ssm_heads``; ``heads_split``:
    ``transformer.split_arch`` gathers the layer whole otherwise): the
    residual whole along the sequence (``lay.enter``), in_proj and the
    conv all-gathered along ``model`` (their contiguous slices straddle
    z | x | B | C | dt) and cut to the rank's columns before the product,
    the per-head vectors sliced to its heads, its rows of out_proj, and
    one sum over ``model`` laid out as the residual (``lay.leave``)."""
    d_in, h, g, n = dims(cfg)
    proj, width = 2 * d_in + 2 * g * n + h, d_in + 2 * g * n
    w = {"in_proj": lay.whole(p["in_proj"], 1, proj),
         "conv": {"w": lay.whole(p["conv"]["w"], 1, width),
                  "b": lay.fork(p["conv"]["b"])},
         "out_proj": p["out_proj"]}
    w.update({k: lay.fork(p[k]) for k in ("a_log", "dt_bias", "d_skip")})
    return lay.leave(ssm_heads(cfg, w, lay.enter(x), lay.m, lay.nm,
                               use_kernel))


def ssm_decode_step_ranks(cfg: ModelConfig, p: Params, cache: Params,
                          specs: Params, x_t: torch.Tensor, lay
                          ) -> tuple[torch.Tensor, Params]:
    """One token through one rank's share of ``ssm_decode_step``: ``x_t``
    (B, 1, D) whole along ``model``, ``cache`` its slices by
    ``cache_specs`` (``specs``, per layer: h's d_state and the conv
    state's channels over ``model``).

    The rank's columns of in_proj give its block of the token's
    projection, all-gathered (one token's columns); the conv state
    advances on the rank's channels (the conv weight's slice is the
    state's: one rule places both) and the conv outputs are all-gathered;
    the state updates on the rank's slice of d_state (elementwise in it),
    and y = Σ_N C·h is summed over ``model`` in rank order in f32; its
    rows of out_proj are summed over ``model``.  Neither state is
    gathered.  A state whole along ``model`` (nm dividing neither d_state
    nor the channels) updates whole on every rank."""
    s_cfg = cfg.ssm
    d_in, h, g, n = dims(cfg)
    bsz, m, comm = x_t.shape[0], lay.m, lay.comm
    proj = x_t[:, 0, :] @ p["in_proj"]
    if proj.shape[-1] != 2 * d_in + 2 * g * n + h:
        proj = comm.gather_model(proj, 1)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv, state = p["conv"], cache["conv"]
    wn = state.shape[-1]
    if wn != xbc.shape[-1]:
        ch = slice(m * wn, (m + 1) * wn)
        out, conv_state = layers.apply_conv_step(
            {"w": conv["w"], "b": conv["b"][ch]}, state, xbc[:, ch])
        xbc = comm.gather_model(out, 1)
    else:
        xbc, conv_state = layers.apply_conv_step(conv, state, xbc)
    xbc = F.silu(xbc)
    x, b_mat, c_mat = _split_xbc(cfg, xbc)

    x = x.reshape(bsz, h, s_cfg.head_dim)
    b_mat = b_mat.reshape(bsz, g, n)
    c_mat = c_mat.reshape(bsz, g, n)
    hs = cache["h"]
    split = partition.model_dim(specs["h"]) is not None
    if split:
        if hs.shape[-1] == n:
            raise ValueError("a decode step over ranks takes the SSM state "
                             "split over d_state or whole")
        nn = hs.shape[-1]
        b_mat = b_mat[..., m * nn:(m + 1) * nn]
        c_mat = c_mat[..., m * nn:(m + 1) * nn]
    b_mat = b_mat.repeat_interleave(h // g, dim=1)
    c_mat = c_mat.repeat_interleave(h // g, dim=1)
    dt = layers.softplus(dt_raw.float() + p["dt_bias"])
    decay = torch.exp(dt * -torch.exp(p["a_log"]))
    h_new = hs * decay[:, :, None, None].to(x.dtype) + \
        _einsum("bhp,bhn,bh->bhpn", x, b_mat, dt.to(x.dtype))
    if split:
        y = comm.sum_model(_einsum("bhn,bhpn->bhp", c_mat.float(),
                                   h_new)).to(x.dtype)
    else:
        y = _einsum("bhn,bhpn->bhp", c_mat, h_new)
    y = y + x * p["d_skip"][None, :, None].to(x.dtype)
    y = y.reshape(bsz, d_in) * F.silu(z)
    o = p["out_proj"]
    if o.shape[0] == d_in:
        out = y @ o
    else:
        out = comm.sum_model(y[:, m * o.shape[0]:(m + 1) * o.shape[0]] @ o)
    return out[:, None, :], {"conv": conv_state, "h": h_new}

