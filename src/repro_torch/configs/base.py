"""Model/config dataclasses for the assigned architectures.

Every architecture file in this package instantiates ``ModelConfig`` with the
exact assigned numbers (source paper / model card cited in its docstring) and
provides a ``reduced()`` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

ArchType = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    first_dense_layers: int = 0     # leading layers with dense FFN
    dense_d_ff: int = 0             # width of those dense FFNs
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD mixer (arXiv:2405.21060)."""
    d_state: int = 128
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RG-LRU + local attention (RecurrentGemma/Griffin, arXiv:2402.19427)."""
    pattern: tuple[str, ...] = ("rglru", "rglru", "attn")
    lru_width: int = 0              # 0 => d_model
    local_window: int = 2048
    conv_kernel: int = 4
    lru_c: float = 8.0


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend (audio/vision): input_specs() provides
    precomputed frame/patch embeddings of this shape (the one allowed stub)."""
    kind: Literal["audio", "vision"] = "vision"
    num_embeddings: int = 256       # patches / frames fed to the backbone
    embed_dim: int = 0              # 0 => d_model (projector output)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    # stack / variant switches
    mlp: Literal["swiglu", "geglu", "relu2", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # long-context attention window
    is_encoder_decoder: bool = False
    num_decoder_layers: int = 0            # enc-dec only
    # substructure configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: Optional[FrontendConfig] = None
    # MTP (multi-token prediction, DeepSeek-V3): one extra predict block
    mtp_depth: int = 0
    # training
    dtype: str = "bfloat16"
    optimizer: str = "adam"         # 'sgd' for the largest archs (see DESIGN)
    learning_rate: float = 3e-4
    remat: bool = True              # activation checkpointing per layer
    grad_accum: int = 1             # microbatch accumulation in train_step
    # citation for the exact numbers above
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0 or \
            self.num_kv_heads == 0
        if self.moe is not None:
            assert self.moe.top_k <= self.moe.num_experts
        if self.arch_type == "ssm":
            assert self.ssm is not None
        if self.is_encoder_decoder:
            assert self.num_decoder_layers > 0

    def param_count(self) -> int:
        """Total parameter count N (for MODEL_FLOPS = 6·N·D roofline)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed)."""
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        p = cfg.d_model * m.q_lora_rank            # q down
        p += m.q_lora_rank * cfg.num_heads * qk_hd  # q up
        p += cfg.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down
        p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim
                                               + m.v_head_dim)    # kv up
        p += cfg.num_heads * m.v_head_dim * cfg.d_model            # o proj
        return p
    q = cfg.d_model * cfg.num_heads * hd
    kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * cfg.d_model
    return q + kv + o


def _layer_params(cfg: ModelConfig, layer_idx: int) -> int:
    """Per-layer params for roofline bookkeeping (norms ignored, <0.1%)."""
    if cfg.arch_type == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        n_heads = d_in // s.head_dim
        proj_in = cfg.d_model * (2 * d_in + 2 * s.n_groups * s.d_state
                                 + n_heads)
        return proj_in + d_in * cfg.d_model + s.conv_kernel * (
            d_in + 2 * s.n_groups * s.d_state)
    if cfg.hybrid is not None:
        kind = cfg.hybrid.pattern[layer_idx % len(cfg.hybrid.pattern)]
        w = cfg.hybrid.lru_width or cfg.d_model
        if kind == "rglru":
            mix = 2 * cfg.d_model * w + w * cfg.d_model + \
                cfg.hybrid.conv_kernel * w + 2 * w * w // 8  # block-diag gates
        else:
            mix = _attn_params(cfg)
        return mix + _ffn_params(cfg, cfg.d_ff)
    p = _attn_params(cfg)
    if cfg.moe is not None and layer_idx >= cfg.moe.first_dense_layers:
        moe = cfg.moe
        p += moe.num_experts * _ffn_params(cfg, moe.d_ff_expert)
        p += moe.num_shared_experts * _ffn_params(cfg, moe.d_ff_expert)
        p += cfg.d_model * moe.num_experts      # router
    elif cfg.moe is not None:
        p += _ffn_params(cfg, cfg.moe.dense_d_ff or cfg.d_ff)
    else:
        p += _ffn_params(cfg, cfg.d_ff)
    return p


def _layer_params_active(cfg: ModelConfig, layer_idx: int) -> int:
    if cfg.moe is None or layer_idx < cfg.moe.first_dense_layers:
        return _layer_params(cfg, layer_idx)
    moe = cfg.moe
    p = _attn_params(cfg)
    p += (moe.top_k + moe.num_shared_experts) * _ffn_params(
        cfg, moe.d_ff_expert)
    p += cfg.d_model * moe.num_experts
    return p


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    fn = _layer_params_active if active_only else _layer_params
    total = sum(fn(cfg, i) for i in range(cfg.num_layers))
    if cfg.is_encoder_decoder:
        # decoder layers: self-attn + cross-attn + ffn
        dec = sum(fn(cfg, i) + _attn_params(cfg)
                  for i in range(cfg.num_decoder_layers))
        total += dec
    emb = cfg.vocab_size * cfg.d_model
    total += emb if cfg.tie_embeddings else 2 * emb
    return total
