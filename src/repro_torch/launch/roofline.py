"""Roofline terms on the card's published figures.

The port's counterpart of ``repro.launch.roofline``.  The card's peaks are
NVIDIA's data-sheet figures per H100 variant (dense rates, no sparsity):
FP32 outside the tensor cores, bf16 on the tensor cores, and HBM
bandwidth; ``peaks()`` reads the variant from
``torch.cuda.get_device_name()`` (the SXM part where no card is present).
The collective term is priced at one direction of NVLink 4 (18 links of
25 GB/s), the link between two agents' cards.  The census the reference
takes from compiled HLO is ``trace_census`` over the op trace
(``analysis.trace``), re-exported here.

Roofline terms, in seconds:

  compute    = flops            / peak FLOP/s (dense bf16 by default)
  memory     = hbm_bytes        / HBM bytes/s
  collective = collective_bytes / NVLink bytes/s, one direction
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.analysis.trace import Census, trace_census

__all__ = [
    "BF16_PEAK", "Census", "FP32_PEAK", "HBM_BW", "LINK_BW", "PEAKS",
    "analytic_hbm_bytes", "bound", "device_name", "fused_agg_traffic",
    "model_flops", "peaks", "roofline_terms", "trace_census",
]

# (FP32 FLOP/s, dense bf16 FLOP/s, HBM bytes/s) per H100 variant, the
# longest name first so that "H100" matches only the SXM part
PEAKS = {"H100 NVL": (60e12, 835e12, 3.9e12),
         "H100 PCIe": (51e12, 756e12, 2.0e12),
         "H100": (67e12, 989e12, 3.35e12)}
FP32_PEAK, BF16_PEAK, HBM_BW = PEAKS["H100"]
LINK_BW = 450e9


def device_name() -> str:
    """The card's name, or the SXM part's where there is no card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "NVIDIA H100 80GB HBM3"


def peaks(name: Optional[str] = None) -> tuple[float, float, float]:
    """(FP32, bf16, HBM) peaks of the H100 variant ``name`` names
    (default: this card's); ValueError for another card."""
    name = device_name() if name is None else name
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise ValueError(f"no published peaks for card {name!r}")


def bound(flops: float, nbytes: float, peak_ops: float,
          peak_bw: float) -> tuple[float, str]:
    """The least time (ms) the card could take for ``flops`` operations at
    ``peak_ops`` and ``nbytes`` moved at ``peak_bw``, and which bounds it
    ("operations" or "bytes")."""
    t_ops, t_bytes = 1e3 * flops / peak_ops, 1e3 * nbytes / peak_bw
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def roofline_terms(flops: float, hbm_bytes: float, collective_total: float,
                   exposed_collective: "float | None" = None, *,
                   peak_flops: Optional[float] = None,
                   hbm_bw: Optional[float] = None,
                   link_bw: Optional[float] = None) -> dict[str, Any]:
    """Per-card terms in seconds.  The peaks default to this card's
    variant: dense bf16, its HBM and one NVLink direction.

    ``exposed_collective`` (bytes) switches the collective term to
    overlap-aware pricing: pass the exposed wire volume of the staged
    exchange schedule (``messages.overlap_stats(...)['exposed_wire_bytes']``)
    and the roofline prices only that, with the full scheduled volume kept
    as ``collective_total_s`` for the no-overlap comparison.
    """
    _, bf16, hbm = peaks()
    peak_flops = bf16 if peak_flops is None else peak_flops
    hbm_bw = hbm if hbm_bw is None else hbm_bw
    link_bw = LINK_BW if link_bw is None else link_bw
    terms = {"compute_s": flops / peak_flops,
             "memory_s": hbm_bytes / hbm_bw}
    if exposed_collective is None:
        terms["collective_s"] = collective_total / link_bw
    else:
        terms["collective_s"] = exposed_collective / link_bw
        terms["collective_total_s"] = collective_total / link_bw
        terms["collective_exposed_bytes"] = float(exposed_collective)
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: terms[k])
    return terms


def fused_agg_traffic(agg_rows: int, site_dims, itemsize: int = 4
                      ) -> dict[str, Any]:
    """Device-memory traffic of the aggregation→GEMM intermediates, per
    shard per iteration, fused against unfused.

    ``agg_rows`` is the row count of each aggregated ``(k, n_pad, C)``
    stack (k·n_pad per shard); ``site_dims`` lists one ``(c_in, c_out)``
    pair per aggregation→GEMM site the fused kernel covers (the Z-update
    targets, not the W-update line-search aggregates, which both paths
    materialise).  Unfused, every site writes its aggregate and the GEMM
    reads it back: 2·rows·c_in·itemsize each.  Fused, the aggregate lives
    in a cluster's shared memory: zero bytes — only the GEMM output
    (identical in both paths) is written.
    """
    unfused = sum(2 * agg_rows * c_in * itemsize for c_in, _ in site_dims)
    gemm_out = sum(agg_rows * c_out * itemsize for _, c_out in site_dims)
    return {"agg_rows": int(agg_rows),
            "sites": len(list(site_dims)),
            "itemsize": int(itemsize),
            "unfused_intermediate_bytes": int(unfused),
            "fused_intermediate_bytes": 0,
            "gemm_out_bytes": int(gemm_out)}


def analytic_hbm_bytes(cfg, shape, step: str, chips: int,
                       model_shards: int = 16) -> float:
    """Algorithmic minimum device-memory traffic per card per step (the
    roofline floor), the reference's formula: parameter reads (+ gradient
    and optimizer traffic for train), residual-stream activations at layer
    granularity (kept on all ``model_shards`` of the reference's mesh),
    logits / CE passes and decode-cache reads."""
    dt = 2 if cfg.dtype == "bfloat16" else 4
    p_bytes = cfg.param_count() * dt / chips
    d = cfg.d_model
    if step == "decode":
        tokens = shape.global_batch            # one per stream
        # cache read is the dominant decode traffic
        if cfg.arch_type == "ssm":
            s_cfg = cfg.ssm
            d_in = s_cfg.expand * d
            cache = (shape.global_batch * cfg.num_layers *
                     (d_in // s_cfg.head_dim) * s_cfg.head_dim *
                     s_cfg.d_state * dt)
        elif cfg.hybrid is not None:
            w = cfg.hybrid.lru_width or d
            n_attn = cfg.num_layers // len(cfg.hybrid.pattern)
            cache = shape.global_batch * (
                cfg.num_layers * w * 4 +        # recurrent states (f32)
                n_attn * min(shape.seq_len, cfg.hybrid.local_window) *
                cfg.num_kv_heads * cfg.resolved_head_dim * 2 * dt)
        elif cfg.mla is not None:
            eff = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
            cache = (shape.global_batch * cfg.num_layers * eff *
                     (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * dt)
        else:
            eff = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
            layers = cfg.num_decoder_layers if cfg.is_encoder_decoder \
                else cfg.num_layers
            cache = (shape.global_batch * layers * eff *
                     cfg.num_kv_heads * cfg.resolved_head_dim * 2 * dt)
        # active params read once (MoE reads only routed experts)
        act_p = cfg.active_param_count() * dt / chips
        return act_p + cache / chips + tokens * d * dt * 10
    tokens_per_chip = (shape.global_batch * shape.seq_len / chips
                       * model_shards)
    layers = cfg.num_layers + (cfg.num_decoder_layers or 0)
    act = tokens_per_chip * d * dt * layers * (30 if step == "train" else 10)
    logits = (shape.global_batch * shape.seq_len * cfg.vocab_size * 4 /
              chips * (4 if step == "train" else 0.01))
    if step == "train":
        accum = max(cfg.grad_accum, 1)
        return p_bytes * (2 * accum + 3) + act + logits
    return p_bytes + act + logits


def model_flops(cfg, shape, step: str) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (train) / 2·N·D (inference)."""
    n = cfg.active_param_count()
    if step == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if step == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
