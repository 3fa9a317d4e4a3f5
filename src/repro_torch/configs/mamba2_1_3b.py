"""Mamba-2 1.3B [arXiv:2405.21060].

48 layers (attention-free), d_model 2048, SSD mixer with d_state 128,
head_dim 64, expand 2, vocab 50280.  Sub-quadratic by construction — runs
long_500k natively.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        arch_type="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        norm="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                      conv_kernel=4, chunk_size=256),
        grad_accum=2,
        source="arXiv:2405.21060",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-reduced",
        arch_type="ssm",
        num_layers=2,
        d_model=256,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, n_groups=1,
                      conv_kernel=4, chunk_size=32),
        dtype="float32",
        source="arXiv:2405.21060 (reduced)",
    )
