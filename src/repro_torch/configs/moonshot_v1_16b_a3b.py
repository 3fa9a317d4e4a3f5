"""Moonlight-16B-A3B (moonshot) [hf:moonshotai/Moonlight-16B-A3B].

Assigned: 48 layers, d_model 2048, 16 heads (kv=16, i.e. MHA), MoE with 64
experts top-6, expert width 1408, vocab 163840.  The HF card uses the
DeepSeek-V3 topology (2 shared experts, fine-grained routing); we follow the
assigned head/kv counts exactly and the card's shared-expert count.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=11264,
        vocab_size=163840,
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=50000.0,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      d_ff_expert=1408, first_dense_layers=1,
                      dense_d_ff=11264),
        grad_accum=4,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-reduced",
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
        source="hf:moonshotai/Moonlight-16B-A3B (reduced)",
    )
