"""SeamlessM4T-medium text decoder backbone [arXiv:2308.11596].

Assigned: 12 layers, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 256206.  Encoder-decoder: 12 encoder + 12 decoder layers (the T2TT
component of the medium card).  The speech frontend (mel + conformer
feature extractor) is STUBBED per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model) for the encoder.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        arch_type="audio",
        num_layers=12,
        num_decoder_layers=12,
        is_encoder_decoder=True,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        mlp="gelu",
        norm="layernorm",
        rope_theta=10000.0,
        frontend=FrontendConfig(kind="audio", num_embeddings=1536),
        grad_accum=2,
        source="arXiv:2308.11596",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-reduced",
        arch_type="audio",
        num_layers=2,
        num_decoder_layers=2,
        is_encoder_decoder=True,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        mlp="gelu",
        norm="layernorm",
        frontend=FrontendConfig(kind="audio", num_embeddings=64),
        dtype="float32",
        source="arXiv:2308.11596 (reduced)",
    )
