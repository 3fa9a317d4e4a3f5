"""DeepSeekMoE 16B [arXiv:2401.06066].

28 layers, d_model 2048, 16 heads MHA (kv=16), fine-grained MoE: 64 routed
experts top-6 + 2 shared experts of width 1408; first layer dense with
d_ff 10944; vocab 102400.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,
        vocab_size=102400,
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      d_ff_expert=1408, first_dense_layers=1,
                      dense_d_ff=10944),
        grad_accum=4,
        source="arXiv:2401.06066",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-reduced",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        mlp="swiglu",
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=2,
                      d_ff_expert=128, first_dense_layers=1, dense_d_ff=512),
        dtype="float32",
        source="arXiv:2401.06066 (reduced)",
    )
