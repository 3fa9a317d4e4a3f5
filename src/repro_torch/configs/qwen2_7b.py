"""Qwen2-7B [arXiv:2407.10671].

28 layers, d_model 3584, 28 heads GQA kv=4 (head_dim 128), SwiGLU d_ff 18944,
QKV bias, vocab 152064.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        arch_type="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        mlp="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope_theta=1000000.0,
        grad_accum=4,
        source="arXiv:2407.10671",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        mlp="swiglu",
        qkv_bias=True,
        dtype="float32",
        source="arXiv:2407.10671 (reduced)",
    )
