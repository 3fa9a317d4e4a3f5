"""RecurrentGemma 9B [arXiv:2402.19427].

38 layers, pattern (RG-LRU, RG-LRU, local-attn) 1:2 — 12 full periods + 2
trailing recurrent blocks; d_model 4096, 16 heads MQA (kv=1, head_dim 256)
for the local-attention blocks (window 2048), GeGLU d_ff 12288,
lru_width 4096, vocab 256000.  Sub-quadratic (bounded window + recurrent
state) — runs long_500k natively.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        arch_type="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        mlp="geglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        tie_embeddings=True,
        hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"),
                            lru_width=4096, local_window=2048,
                            conv_kernel=4, lru_c=8.0),
        grad_accum=4,
        source="arXiv:2402.19427",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced",
        arch_type="hybrid",
        num_layers=5,          # 1 period + 2 tail rglru blocks
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        mlp="geglu",
        tie_embeddings=True,
        hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"),
                            lru_width=256, local_window=64,
                            conv_kernel=4, lru_c=8.0),
        dtype="float32",
        source="arXiv:2402.19427 (reduced)",
    )
