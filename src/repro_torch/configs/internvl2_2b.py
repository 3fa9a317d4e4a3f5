"""InternVL2-2B language backbone (InternLM2-1.8B) [arXiv:2404.16821].

24 layers, d_model 2048, 16 heads GQA kv=8, SwiGLU d_ff 8192, vocab 92553.
The InternViT vision encoder + MLP projector are STUBBED per the
assignment: input_specs() provides 256 projected patch embeddings
(B, 256, d_model) prepended to the text tokens.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        arch_type="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=1000000.0,
        frontend=FrontendConfig(kind="vision", num_embeddings=256),
        grad_accum=2,
        source="arXiv:2404.16821",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-reduced",
        arch_type="vlm",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        mlp="swiglu",
        frontend=FrontendConfig(kind="vision", num_embeddings=16),
        dtype="float32",
        source="arXiv:2404.16821 (reduced)",
    )
