"""Attention variants: MHA/GQA/MQA (+bias, RoPE), MLA, sliding window, caches.

The port of src/repro/models/attention.py.  Full-sequence self-attention
(``attend``) takes one of two routes:

* ``use_kernel=False``: ``block_causal_attention``, the reference's
  chunked form: a loop over query chunks where chunk i only contracts
  against keys [lo_i, hi_i), so no full S² score buffer is made;
* ``use_kernel=True``: ``kernels.ops.flash_attention``, the hand-written
  CUDA kernel on a CUDA tensor (bf16 on the tensor cores, f32 on FFMA) and
  its plain version on a CPU tensor.  The kernel masks q − k ≥ window with
  or without ``causal``, while the reference applies the window only when
  ``causal`` if S ≤ CHUNK, and always if S > CHUNK; ``attend`` passes the
  window only where the reference applies it.  MLA's v (v_hd < qk_hd) is
  padded with zero columns to qk_hd and the output sliced back, which is
  exact; the kernel's scale 1/√qk_hd is ``_sdpa``'s.  Both routes take the
  same inputs: above CHUNK, S must be a multiple of it.

Cross-attention and every decode step stay plain torch (``_sdpa``, one
query row), as in the reference.

Over the ranks of a ``ProcessMesh`` under ``sharding_hints`` (the
reference's ``hints.hint_qkv``, ``sharding.hints.qkv_layout``),
``gqa_forward_ranks`` runs one rank's share: the ``heads`` branch takes
the rank's Hq/nm and Hkv/nm heads from the column-split q/k/v, attends,
and sums the row-split ``o`` projection over ``model``; the ``context``
branch takes the rank's query rows, which attend to every key at a query
offset (both routes take ``q_offset``).  ``gqa_decode_step_ranks`` runs a
decode step on caches placed by ``cache_specs`` (head_dim, else heads,
over ``model``).  Cross-attention splits on the heads
(``gqa_cross_forward_ranks``: the encoder's memory whole along ``model``;
``gqa_cross_step_ranks`` on the rank's slices of the memory caches).

Caches (a decode step writes its token into the cache it is given, in
place, and returns the same tensors; a caller that keeps the pre-step
cache clones it first):
  full cache    {'k','v': (B, S_max, Hkv, hd), 'slot_pos': (S_max,),
                 'pos': ()}
  rolling cache the same with S_max = W (sliding window / long_500k)
  MLA cache     {'c_kv': (B, S, r), 'k_rope': (B, S, 1, hd_r), 'pos': ()}
                (compressed latent — the point of MLA)
``pos`` and ``slot_pos`` are int32 tensors: a step reads them on the
device, with no copy to the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.layers import Params, apply_rope, dense_init, dtype_of
from repro_torch.sharding import hints, partition

NEG_INF = -2.0 ** 30  # large-negative in f32 (avoids bf16 overflow on cast)
CHUNK = 2048          # query/key chunk for block-causal attention


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "q_down": dense_init(gen, (cfg.d_model, m.q_lora_rank), dt),
            "q_norm": {"scale": torch.ones((m.q_lora_rank,), dtype=dt,
                                           device=gen.device)},
            "q_up": dense_init(gen, (m.q_lora_rank, cfg.num_heads * qk_hd),
                               dt),
            "kv_down": dense_init(gen, (cfg.d_model, m.kv_lora_rank
                                        + m.qk_rope_head_dim), dt),
            "kv_norm": {"scale": torch.ones((m.kv_lora_rank,), dtype=dt,
                                            device=gen.device)},
            "kv_up": dense_init(gen, (m.kv_lora_rank, cfg.num_heads
                                      * (m.qk_nope_head_dim + m.v_head_dim)),
                                dt),
            "o": dense_init(gen, (cfg.num_heads * m.v_head_dim, cfg.d_model),
                            dt),
        }
    p = {
        "q": dense_init(gen, (cfg.d_model, cfg.num_heads * hd), dt),
        "k": dense_init(gen, (cfg.d_model, cfg.num_kv_heads * hd), dt),
        "v": dense_init(gen, (cfg.d_model, cfg.num_kv_heads * hd), dt),
        "o": dense_init(gen, (cfg.num_heads * hd, cfg.d_model), dt),
    }
    if cfg.qkv_bias:
        for name, heads in (("q_b", cfg.num_heads), ("k_b", cfg.num_kv_heads),
                            ("v_b", cfg.num_kv_heads)):
            p[name] = torch.zeros((heads * hd,), dtype=dt, device=gen.device)
    return p


def init_cross_attention(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return init_attention(cfg, gen)   # same projections, keys from memory


# ---------------------------------------------------------------------------
# core score/combine (single q-block vs single kv-block)
# ---------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k: (B,S,*,qk_hd); v: (B,Sk,Hkv,v_hd); mask bcastable (B,1,Sq,Sk).

    Scores in f32 (the reference's ``preferred_element_type``: products of
    bf16 values are exact in f32), probabilities cast to v's dtype.  v_hd
    may differ from qk_hd (MLA decompresses to different dims)."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    scores = _scores(q.reshape(b, sq, hkv, h // hkv, hd), k)
    if mask is not None and mask.dim() == 4:
        mask = mask[:, :, None]
    return _mix(scores, mask, v, hd).reshape(b, sq, h, v.shape[-1])


def _scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scores (B, Hkv, G, Sq, Sk) of grouped queries qg (B, Sq, Hkv,
    G, d) against k (B, Sk, Hkv, d)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())


def _mix(scores: torch.Tensor, mask: Optional[torch.Tensor],
         v: torch.Tensor, hd: int) -> torch.Tensor:
    """The softmax of the scaled, masked scores, cast to v's dtype, over v
    (B, Sk, Hkv, v_hd): (B, Sq, Hkv, G, v_hd)."""
    scores = scores * (1.0 / math.sqrt(hd))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


def _check_length(s: int, chunk: int) -> None:
    if s > chunk and s % chunk:
        raise ValueError(f"sequence length {s} above the chunk {chunk} is "
                         f"not a multiple of it")


def block_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None,
                           chunk: int = CHUNK,
                           q_offset: int = 0) -> torch.Tensor:
    """Chunked attention with static per-chunk key slices (causal FLOPs only).

    k/v over the sequence, (B,S,Hkv,hd); q: (B,S_q,H,hd), the rows at
    positions ``q_offset`` .. ``q_offset`` + S_q − 1 of it (all of it by
    default): each row is masked and contracted against the keys of its
    chunk of the whole call, so a slice gives the whole call's rows.
    """
    s, sq = k.shape[1], q.shape[1]
    dev = q.device
    if s <= chunk:
        mask = None
        if causal:
            qpos = torch.arange(q_offset, q_offset + sq, device=dev)
            kpos = torch.arange(s, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            mask = mask[None, None]
        return _sdpa(q, k, v, mask)

    _check_length(s, chunk)
    outs = []
    for i in range(s // chunk):
        q_lo, q_hi = i * chunk, (i + 1) * chunk
        lo, hi = max(q_lo, q_offset), min(q_hi, q_offset + sq)
        if lo >= hi:
            continue
        k_lo = 0 if window is None else max(0, q_lo - window)
        k_lo = (k_lo // chunk) * chunk           # align to chunk
        k_hi = q_hi if causal else s
        qpos = torch.arange(lo, hi, device=dev)
        kpos = torch.arange(k_lo, k_hi, device=dev)
        mask = torch.ones((hi - lo, k_hi - k_lo), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        outs.append(_sdpa(q[:, lo - q_offset:hi - q_offset], k[:, k_lo:k_hi],
                          v[:, k_lo:k_hi], mask[None, None]))
    return torch.cat(outs, dim=1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           use_kernel: bool = False, chunk: int = CHUNK,
           q_offset: int = 0) -> torch.Tensor:
    """Full-sequence self-attention through the plain route or the flash
    kernel (module docstring); both return what the reference's
    ``block_causal_attention`` returns.  q, k: (B,S,*,qk_hd); v:
    (B,S,Hkv,v_hd) with v_hd ≤ qk_hd.  q may hold the rows at positions
    ``q_offset`` .. of the sequence only (a context-parallel rank's)."""
    if not use_kernel:
        return block_causal_attention(q, k, v, causal=causal, window=window,
                                      chunk=chunk, q_offset=q_offset)
    s, qk_hd, v_hd = k.shape[1], q.shape[-1], v.shape[-1]
    _check_length(s, chunk)
    if s <= chunk and not causal:
        window = None                # the reference's S ≤ CHUNK branch
    if v_hd > qk_hd:
        raise ValueError(f"v head_dim {v_hd} > q/k head_dim {qk_hd}")
    if v_hd < qk_hd:
        v = F.pad(v, (0, qk_hd - v_hd))
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return out[..., :v_hd]


# ---------------------------------------------------------------------------
# GQA attention (train/prefill + cached decode)
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q, k, v = x @ p["q"], x @ p["k"], x @ p["v"]
    if cfg.qkv_bias:
        q, k, v = q + p["q_b"], k + p["k_b"], v + p["v_b"]
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def _positions(s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :]


def gqa_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                causal: bool = True, window: Optional[int] = None,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(s, x.device)
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, causal=causal, window=window,
                 use_kernel=use_kernel)
    return out.reshape(b, s, -1) @ p["o"]


def gqa_cross_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      memory: torch.Tensor) -> torch.Tensor:
    """Cross-attention: queries from x, keys/values from encoder memory."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    sm = memory.shape[1]
    q = (x @ p["q"]).reshape(b, s, cfg.num_heads, hd)
    k = (memory @ p["k"]).reshape(b, sm, cfg.num_kv_heads, hd)
    v = (memory @ p["v"]).reshape(b, sm, cfg.num_kv_heads, hd)
    if cfg.qkv_bias:
        q = q + p["q_b"].reshape(cfg.num_heads, hd)
        k = k + p["k_b"].reshape(cfg.num_kv_heads, hd)
        v = v + p["v_b"].reshape(cfg.num_kv_heads, hd)
    out = _sdpa(q, k, v, None)
    return out.reshape(b, s, -1) @ p["o"]


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   rolling: bool = False,
                   device: torch.device | None = None) -> Params:
    hd = cfg.resolved_head_dim
    dt = dict(dtype=dtype_of(cfg), device=device)
    i32 = dict(dtype=torch.int32, device=device)
    size = min(max_len, cfg.sliding_window) if rolling and cfg.sliding_window \
        else max_len
    return {
        "k": torch.zeros((batch, size, cfg.num_kv_heads, hd), **dt),
        "v": torch.zeros((batch, size, cfg.num_kv_heads, hd), **dt),
        "slot_pos": torch.full((size,), -1, **i32),
        "pos": torch.zeros((), **i32),
    }


def gqa_decode_step(cfg: ModelConfig, p: Params, cache: Params,
                    x_t: torch.Tensor, rolling: bool = False
                    ) -> tuple[torch.Tensor, Params]:
    """One token: x_t (B, 1, D) against the cache, written in place."""
    b = x_t.shape[0]
    pos = cache["pos"]
    q, k, v = _project_qkv(cfg, p, x_t)
    positions = pos.expand(b, 1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    valid = _write_token(cfg, cache, k, v, rolling)
    out = _sdpa(q, cache["k"], cache["v"], valid[None, None, None, :])
    cache["pos"].add_(1)
    return out.reshape(b, 1, -1) @ p["o"], cache


def _write_token(cfg: ModelConfig, cache: Params, k: torch.Tensor,
                 v: torch.Tensor, rolling: bool) -> torch.Tensor:
    """The token at ``cache["pos"]``: its k and v (B, 1, ...) written at
    its slot, and the (S_max,) mask of the slots it attends to."""
    pos = cache["pos"]
    size = cache["k"].shape[1]
    slot = (pos % size if rolling else pos.clamp(max=size - 1)).long()
    slot = slot.view(1)
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    cache["slot_pos"].index_copy_(0, slot, pos.view(1))
    slot_pos = cache["slot_pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.sliding_window is not None:
        valid &= slot_pos > pos - cfg.sliding_window
    return valid


# ---------------------------------------------------------------------------
# GQA over the ranks of a data × model mesh (hints.qkv_layout)
# ---------------------------------------------------------------------------

def _bias(p: Params, name: str, width: int, full: int, m: int, lay=None):
    """Rank ``m``'s ``width`` columns of a bias (whole on every rank);
    with ``lay``, its gradient by the layout's convention
    (``RankLayout.fork``)."""
    b = p[name]
    if width == full:
        return b
    return (b if lay is None else lay.fork(b))[m * width:(m + 1) * width]


def gqa_forward_ranks(cfg: ModelConfig, p: Params, x: torch.Tensor, lay, *,
                      causal: bool = True, window: Optional[int] = None,
                      use_kernel: bool = False) -> torch.Tensor:
    """This rank's share of ``gqa_forward`` under the hints: ``x`` is its
    piece of the (normed) residual (``lay``: hints.RankLayout), ``p`` its
    shards by ``param_specs`` (the data axes gathered); returns its piece
    of the output.

    ``heads``: the residual whole along model (``lay.enter``), the rank's
    Hq/nm and Hkv/nm heads from its column slices of q/k/v, attention on
    them, its row slice of ``o``, and one sum over model laid out as the
    residual (``lay.leave``).  ``context``: q/k/v/o whole (all-gathered),
    the rank's query rows against every key at the query offset of its
    positions, the output already in the residual's layout.  Neither: the
    weights whole and the one-process layer on the whole residual.  Each
    branch carries gradients (the layout's conventions: the heads'
    all-gather and reduce-scatter, the context branch's whole weights
    reduce-scattered back)."""
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    branch, _ = hints.qkv_layout((lay.batch, lay.seq, hq, hd),
                                 (lay.batch, lay.seq, hkv, hd), lay.mesh)
    b, s = x.shape[0], lay.seq
    if branch == "heads":
        nq, nk, m = hq // lay.nm, hkv // lay.nm, lay.m
        xf = lay.enter(x)
        q, k, v = xf @ p["q"], xf @ p["k"], xf @ p["v"]
        if cfg.qkv_bias:
            q = q + _bias(p, "q_b", nq * hd, hq * hd, m, lay)
            k = k + _bias(p, "k_b", nk * hd, hkv * hd, m, lay)
            v = v + _bias(p, "v_b", nk * hd, hkv * hd, m, lay)
        positions = _positions(s, x.device)
        q = apply_rope(q.reshape(b, s, nq, hd), positions, cfg.rope_theta)
        k = apply_rope(k.reshape(b, s, nk, hd), positions, cfg.rope_theta)
        out = attend(q, k, v.reshape(b, s, nk, hd), causal=causal,
                     window=window, use_kernel=use_kernel)
        return lay.leave(out.reshape(b, s, nq * hd) @ p["o"])
    # context: every rank uses the weights on its own query rows; neither:
    # every rank runs the whole layer alike
    back = "scatter" if branch == "context" else "slice"
    w = dict(p, q=lay.whole(p["q"], 1, hq * hd, back),
             k=lay.whole(p["k"], 1, hkv * hd, back),
             v=lay.whole(p["v"], 1, hkv * hd, back),
             o=lay.whole(p["o"], 0, hq * hd, back))
    if branch is None:
        return gqa_forward(cfg, w, x, causal=causal, window=window,
                           use_kernel=use_kernel)
    rows = lay.positions
    sq = rows.stop - rows.start
    q = x @ w["q"]
    if cfg.qkv_bias:
        q = q + w["q_b"]
    q = apply_rope(q.reshape(b, sq, hq, hd),
                   torch.arange(rows.start, rows.stop, device=x.device)[None],
                   cfg.rope_theta)
    xf = lay.enter(x)
    k, v = xf @ w["k"], xf @ w["v"]
    if cfg.qkv_bias:
        k, v = k + w["k_b"], v + w["v_b"]
    k = apply_rope(k.reshape(b, s, hkv, hd), _positions(s, x.device),
                   cfg.rope_theta)
    v = v.reshape(b, s, hkv, hd)
    out = attend(q, k, v, causal=causal, window=window,
                 use_kernel=use_kernel, q_offset=rows.start)
    return out.reshape(b, sq, hq * hd) @ w["o"]


def gqa_decode_step_ranks(cfg: ModelConfig, p: Params, cache: Params,
                          specs: Params, x_t: torch.Tensor, lay,
                          rolling: bool = False
                          ) -> tuple[torch.Tensor, Params]:
    """One token through one rank's share of ``gqa_decode_step``: ``x_t``
    (B, 1, D) whole along ``model`` (this rank's rows), ``cache`` its
    slices by ``cache_specs`` (``specs``, per layer; its sequence and
    ``slot_pos`` whole), written in place.  q, k and v come whole from the
    column slices (one all-gather); the cache holds the rank's slice of
    head_dim (or of the heads) over ``model``, so a head_dim slice gives
    partial scores summed over ``model`` in rank order (every rank then
    holds the same softmax), the rank's slice of each head's output is
    all-gathered, and its rows of the row-split ``o`` are summed over
    ``model``."""
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    group = hq // hkv
    b, m, nm = x_t.shape[0], lay.m, lay.nm
    pos = cache["pos"]
    fulls = (hq * hd, hkv * hd, hkv * hd)
    cols = [x_t @ p[n] for n in ("q", "k", "v")]
    if cfg.qkv_bias:
        cols = [c + _bias(p, f"{n}_b", c.shape[-1], f, m)
                for c, n, f in zip(cols, ("q", "k", "v"), fulls)]
    if any(c.shape[-1] != f for c, f in zip(cols, fulls)):
        widths = [c.shape[-1] for c in cols]
        parts = [pt.split(widths, -1) for pt in
                 lay.comm.model_parts(torch.cat(cols, -1))]
        cols = [c if c.shape[-1] == f else torch.cat([pt[i] for pt in parts],
                                                     -1)
                for i, (c, f) in enumerate(zip(cols, fulls))]
    positions = pos.expand(b, 1)
    q = apply_rope(cols[0].reshape(b, 1, hq, hd), positions, cfg.rope_theta)
    k = apply_rope(cols[1].reshape(b, 1, hkv, hd), positions, cfg.rope_theta)
    v = cols[2].reshape(b, 1, hkv, hd)

    split = partition.model_dim(specs["k"])           # 2: heads, 3: head_dim
    kv_spec = (None, None) + tuple(specs["k"][2:])
    valid = _write_token(cfg, cache,
                         partition.local_slice(k, kv_spec, lay.mesh),
                         partition.local_slice(v, kv_spec, lay.mesh),
                         rolling)

    out = _cached_ranks(q, cache["k"], cache["v"], split,
                        valid[None, None, None, None, :], group, lay)
    cache["pos"].add_(1)
    return _out_rows(out.reshape(b, 1, hq * hd), p["o"], lay), cache


def _cached_ranks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  split: Optional[int], mask: Optional[torch.Tensor],
                  group: int, lay) -> torch.Tensor:
    """One token's queries ``q`` (B, 1, Hq, hd, whole on every rank)
    against a rank's slices ``k`` / ``v`` of a cache, split over ``model``
    on its heads (``split`` 2), on head_dim (3: partial scores summed over
    ``model`` in rank order) or not at all; (B, 1, Hq / Hkv, group, hd)
    whole on every rank."""
    b, _, hq, hd = q.shape
    m, nm = lay.m, lay.nm
    if split == 2:
        nq = hq // nm
        q = q[:, :, m * nq:(m + 1) * nq]
    qg = q.reshape(b, 1, -1, group, hd)
    if split == 3:
        w = hd // nm
        qg = qg[..., m * w:(m + 1) * w]
    scores = _scores(qg, k)
    if split == 3:
        scores = lay.comm.sum_model(scores)
    out = _mix(scores, mask, v, hd)
    if split is not None:
        out = lay.comm.gather_model(out, 2 if split == 2 else 4)
    return out


def _out_rows(out: torch.Tensor, o: torch.Tensor, lay) -> torch.Tensor:
    """``out`` (whole along ``model``) through the rank's rows of the
    row-split ``o``, summed over ``model`` (or through ``o`` whole)."""
    if o.shape[0] == out.shape[-1]:
        return out @ o
    n, m = o.shape[0], lay.m
    return lay.comm.sum_model(out[..., m * n:(m + 1) * n] @ o)


def gqa_cross_forward_ranks(cfg: ModelConfig, p: Params, x: torch.Tensor,
                            memory: torch.Tensor, lay) -> torch.Tensor:
    """This rank's share of ``gqa_cross_forward`` under the hints: ``x``
    its piece of the (normed) decoder residual, ``memory`` (B, S_m, D) the
    encoder's output whole along ``model`` (entered once a forward and
    read by every decoder layer: its gradient partial on each rank), ``p``
    its shards by ``param_specs``; the heads divide over ``model``
    (``transformer.split_arch``).  The decoder residual whole along
    ``model`` (``lay.enter``), queries from the rank's Hq/nm heads, keys
    and values of its Hkv/nm heads from the memory, its row slice of
    ``o`` and one sum over ``model`` laid out as the residual
    (``lay.leave``)."""
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    nq, nk, m = hq // lay.nm, hkv // lay.nm, lay.m
    xf = lay.enter(x)
    b, s = xf.shape[:2]
    sm = memory.shape[1]
    q = (xf @ p["q"]).reshape(b, s, nq, hd)
    k = (memory @ p["k"]).reshape(b, sm, nk, hd)
    v = (memory @ p["v"]).reshape(b, sm, nk, hd)
    if cfg.qkv_bias:
        q = q + _bias(p, "q_b", nq * hd, hq * hd, m, lay).reshape(nq, hd)
        k = k + _bias(p, "k_b", nk * hd, hkv * hd, m, lay).reshape(nk, hd)
        v = v + _bias(p, "v_b", nk * hd, hkv * hd, m, lay).reshape(nk, hd)
    out = _sdpa(q, k, v, None)
    return lay.leave(out.reshape(b, s, nq * hd) @ p["o"])


def gqa_cross_step_ranks(cfg: ModelConfig, p: Params, cache: Params,
                         specs: Params, x_t: torch.Tensor, lay
                         ) -> torch.Tensor:
    """One token's cross-attention (``p`` the rank's shards of it, ``x_t``
    (B, 1, D) whole along ``model``) on one rank against its slices of the
    memory's k / v caches (``cache["cross_k"]`` / ``cache["cross_v"]`` by
    ``cache_specs``: head_dim, else heads, over ``model``): the query
    whole from the column slices of q (one all-gather; no q bias, as the
    reference's step), the scores over the cache (partial over head_dim,
    summed over ``model``), the heads' outputs all-gathered and the rank's
    rows of ``o`` summed over ``model``."""
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    b = x_t.shape[0]
    q = x_t @ p["q"]
    if q.shape[-1] != hq * hd:
        q = lay.comm.gather_model(q, 2)
    out = _cached_ranks(q.reshape(b, 1, hq, hd), cache["cross_k"],
                        cache["cross_v"],
                        partition.model_dim(specs["cross_k"]), None,
                        hq // hkv, lay)
    return _out_rows(out.reshape(b, 1, hq * hd), p["o"], lay)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3) — compressed-latent cache; absorbed decode
# ---------------------------------------------------------------------------

def _mla_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor):
    m = cfg.mla
    b, s, _ = x.shape
    cq = layers.apply_norm(cfg, p["q_norm"], x @ p["q_down"])
    q = (cq @ p["q_up"]).reshape(b, s, cfg.num_heads, m.qk_nope_head_dim
                                 + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ p["kv_down"]
    c_kv, k_rope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = layers.apply_norm(cfg, p["kv_norm"], c_kv)       # (B,S,r)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                      # (B,S,1,hd_r)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence MLA (train / prefill): decompress k/v, then attend."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    if positions is None:
        positions = _positions(s, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    kv = (c_kv @ p["kv_up"]).reshape(b, s, h,
                                     m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    out = attend(q, k, v, causal=True, window=window, use_kernel=use_kernel)
    return out.reshape(b, s, h * m.v_head_dim) @ p["o"]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device | None = None) -> Params:
    m = cfg.mla
    dt = dict(dtype=dtype_of(cfg), device=device)
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), **dt),
        "k_rope": torch.zeros((batch, max_len, 1, m.qk_rope_head_dim), **dt),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode_step(cfg: ModelConfig, p: Params, cache: Params,
                    x_t: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """Absorbed MLA decode: scores in latent space — O(S·r) per head group,
    the compressed cache never decompresses to per-head K/V."""
    m = cfg.mla
    b = x_t.shape[0]
    h = cfg.num_heads
    nope = m.qk_nope_head_dim
    pos = cache["pos"]
    q_nope, q_rope, c_kv_t, k_rope_t = _mla_qkv(cfg, p, x_t,
                                                pos.expand(b, 1))
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_max = c_kv.shape[1]
    at = pos.clamp(max=s_max - 1).long().view(1)
    c_kv.index_copy_(1, at, c_kv_t)
    k_rope.index_copy_(1, at, k_rope_t)

    # absorb W_uk into q: q_lat (B,1,H,r).  kv_up columns are laid out
    # per-head interleaved [k_nope | v] (matching mla_forward's reshape)
    w_full = p["kv_up"].reshape(m.kv_lora_rank, h, nope + m.v_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_full[:, :, :nope])
    scores = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c_kv.float())
    scores = scores + torch.einsum("bqhd,bkzd->bhqk", q_rope.float(),
                                   k_rope.float())
    scores = scores * (1.0 / math.sqrt(nope + m.qk_rope_head_dim))
    valid = torch.arange(s_max, device=x_t.device) <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)

    # combine in latent space, then decompress through W_uv
    lat = torch.einsum("bhqk,bkr->bqhr", probs.to(c_kv.dtype), c_kv)
    out = torch.einsum("bqhr,rhd->bqhd", lat, w_full[:, :, nope:])
    cache["pos"].add_(1)
    return out.reshape(b, 1, h * m.v_head_dim) @ p["o"], cache


# ---------------------------------------------------------------------------
# MLA over the ranks of a data × model mesh (hints.qkv_layout)
# ---------------------------------------------------------------------------

def _mla_latents(cfg: ModelConfig, p: Params, x: torch.Tensor, lay,
                 positions: torch.Tensor):
    """The low-rank latents of ``x`` (this rank's piece of the normed
    residual, at ``positions``): (c_q (B, S, q_lora), c_kv (B, S, r),
    k_rope (B, S, 1, hd_r)) normed and rotated, whole along the sequence
    and the same on every rank, for the ranks' split work on them.

    ``param_specs`` splits q_down and kv_down on their input dim (D) over
    ``model``.  With the residual split along the sequence they are
    all-gathered and the rank forms the latents of its own positions,
    which are then all-gathered along the sequence (r + q_lora + hd_r
    columns a position, not the residual's D).  With the residual whole
    (a decode step) the rank's slice of D times its rows of the weights
    gives partial latents, summed over ``model`` in rank order: no weight
    moves, only the token's latents."""
    m = cfg.mla
    d, qr, r = cfg.d_model, m.q_lora_rank, m.kv_lora_rank
    wq, wkv = p["q_down"], p["kv_down"]
    if lay.seq_split:
        wq, wkv = lay.whole(wq, 0, d), lay.whole(wkv, 0, d)
    if wq.shape[0] == d:
        lat = torch.cat([x @ wq, x @ wkv], -1)
    else:
        n = wq.shape[0]
        xs = lay.fork(x)[..., lay.m * n:(lay.m + 1) * n]
        lat = lay.comm.sum_model(torch.cat([xs @ wq, xs @ wkv], -1))
    c_q, c_kv, k_rope = torch.split(lat, [qr, r, m.qk_rope_head_dim], -1)
    c_q = layers.apply_norm(cfg, p["q_norm"], c_q)
    c_kv = layers.apply_norm(cfg, p["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    if lay.seq_split:
        b, sp = x.shape[:2]
        lat = lay.join(torch.cat([c_q, c_kv, k_rope.reshape(b, sp, -1)], -1),
                       1)
        c_q, c_kv, k_rope = torch.split(lat, [qr, r, m.qk_rope_head_dim], -1)
        return c_q, c_kv, k_rope[:, :, None, :]
    return lay.fork(c_q), lay.fork(c_kv), lay.fork(k_rope)


def mla_forward_ranks(cfg: ModelConfig, p: Params, x: torch.Tensor, lay, *,
                      window: Optional[int] = None,
                      use_kernel: bool = False) -> torch.Tensor:
    """This rank's share of ``mla_forward`` under the hints: ``x`` its
    piece of the (normed) residual, ``p`` its shards by ``param_specs``
    (the data axes gathered); returns its piece of the output.

    The rank's heads (H divisible by nm: ``transformer.split_arch``
    gathers the layer whole otherwise): the latents (``_mla_latents``:
    q_down / kv_down gathered, the latents of the rank's positions
    all-gathered along the sequence), then the rank's H/nm heads from its
    column slices of q_up and kv_up (whole heads: H/nm · (nope + rope) and
    H/nm · (nope + v) columns), k_rope (one head shared by all) on each,
    attention on them (``attend``: the flash kernel on the card), its row
    slice of ``o``, and one sum over ``model`` laid out as the residual
    (``lay.leave``)."""
    m = cfg.mla
    h, nope, rope, vd = (cfg.num_heads, m.qk_nope_head_dim,
                         m.qk_rope_head_dim, m.v_head_dim)
    qk = nope + rope
    b, s = x.shape[0], lay.seq
    nh = h // lay.nm
    rows = lay.positions
    c_q, c_kv, k_rope = _mla_latents(
        cfg, p, x, lay,
        torch.arange(rows.start, rows.stop, device=x.device)[None])
    q = (c_q @ p["q_up"]).reshape(b, s, nh, qk)
    q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)
    q_rope = apply_rope(q_rope, _positions(s, x.device), cfg.rope_theta)
    kv = (c_kv @ p["kv_up"]).reshape(b, s, nh, nope + vd)
    k_nope, v = torch.split(kv, [nope, vd], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, nh, rope)], dim=-1)
    out = attend(q, k, v, causal=True, window=window, use_kernel=use_kernel)
    return lay.leave(out.reshape(b, s, nh * vd) @ p["o"])


def mla_decode_step_ranks(cfg: ModelConfig, p: Params, cache: Params,
                          specs: Params, x_t: torch.Tensor, lay
                          ) -> tuple[torch.Tensor, Params]:
    """One token through one rank's share of ``mla_decode_step``: ``x_t``
    (B, 1, D) whole along ``model``, ``cache`` its slices by
    ``cache_specs`` (``specs``, per layer: c_kv's r and k_rope's hd_r over
    ``model``), written in place; H divisible by nm.

    The token's latents come whole from partial products
    (``_mla_latents``); the rank writes its slices of them.  It absorbs
    W_uk into its H/nm heads' queries (its columns of kv_up), and the
    heads' latent and rope queries are all-gathered: every rank then holds
    every head's query on its slice of r and of hd_r, and its scores are
    partial over them.  The scores are reduce-scattered over the heads
    (summed in f32 in rank order), each rank takes the softmax of its
    heads', and the probabilities are all-gathered; each rank mixes its
    slice of the cache's latents for every head, the slices are
    all-gathered along r, and the rank decompresses its heads through its
    W_uv columns and its rows of ``o``, summed over ``model``.  No
    collective carries the cache."""
    m = cfg.mla
    h, nope, rope, vd, r = (cfg.num_heads, m.qk_nope_head_dim,
                            m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank)
    b, mm, nm = x_t.shape[0], lay.m, lay.nm
    nh = h // nm
    heads = slice(mm * nh, (mm + 1) * nh)
    pos = cache["pos"]
    positions = pos.expand(b, 1)
    c_q, c_kv_t, k_rope_t = _mla_latents(cfg, p, x_t, lay, positions)
    q = (c_q @ p["q_up"]).reshape(b, 1, nh, nope + rope)
    q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    w = p["kv_up"].reshape(r, nh, nope + vd)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w[:, :, :nope])
    qs = lay.comm.gather_model(torch.cat([q_lat, q_rope], -1), 2)

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_max = c_kv.shape[1]
    at = pos.clamp(max=s_max - 1).long().view(1)
    c_kv.index_copy_(1, at, partition.local_slice(
        c_kv_t, (None, None) + tuple(specs["c_kv"][2:]), lay.mesh))
    k_rope.index_copy_(1, at, partition.local_slice(
        k_rope_t, (None, None) + tuple(specs["k_rope"][2:]), lay.mesh))

    rn, en = c_kv.shape[-1], k_rope.shape[-1]
    r_lo = mm * rn if rn != r else 0
    e_lo = r + (mm * en if en != rope else 0)
    lat_s = torch.einsum("bqhr,bkr->bhqk", qs[..., r_lo:r_lo + rn].float(),
                         c_kv.float())
    rope_s = torch.einsum("bqhd,bkzd->bhqk", qs[..., e_lo:e_lo + en].float(),
                          k_rope.float())
    if rn != r and en != rope:
        scores = lay.comm.reduce_scatter_model(lat_s + rope_s, 1)
    elif rn != r:
        scores = lay.comm.reduce_scatter_model(lat_s, 1) + rope_s[:, heads]
    elif en != rope:
        scores = lat_s[:, heads] + lay.comm.reduce_scatter_model(rope_s, 1)
    else:
        scores = (lat_s + rope_s)[:, heads]
    scores = scores * (1.0 / math.sqrt(nope + rope))
    valid = torch.arange(s_max, device=x_t.device) <= pos
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = lay.comm.gather_model(torch.softmax(scores, dim=-1)
                                  .to(c_kv.dtype), 1)

    lat = torch.einsum("bhqk,bkr->bqhr", probs, c_kv)
    if rn != r:
        lat = lay.comm.gather_model(lat, 3)
    out = torch.einsum("bqhr,rhd->bqhd", lat[:, :, heads], w[:, :, nope:])
    cache["pos"].add_(1)
    return lay.comm.sum_model(out.reshape(b, 1, nh * vd) @ p["o"]), cache
