"""Nemotron-4 15B [arXiv:2402.16819].

32 layers, d_model 6144, 48 heads GQA kv=8, d_ff 24576 with squared-ReLU
(non-gated) MLP, vocab 256000, RoPE, no bias.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=256000,
        mlp="relu2",
        norm="layernorm",
        rope_theta=10000.0,
        grad_accum=4,
        source="arXiv:2402.16819",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        mlp="relu2",
        norm="layernorm",
        dtype="float32",
        source="arXiv:2402.16819 (reduced)",
    )
