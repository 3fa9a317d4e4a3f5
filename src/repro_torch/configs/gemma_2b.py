"""Gemma 2B [arXiv:2403.08295].

18 layers, d_model 2048, 8 heads MQA (kv=1) with head_dim 256, GeGLU MLP
d_ff 16384, vocab 256000, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp="geglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        tie_embeddings=True,
        grad_accum=4,
        source="arXiv:2403.08295",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        mlp="geglu",
        tie_embeddings=True,
        dtype="float32",
        source="arXiv:2403.08295 (reduced)",
    )
