"""DeepSeek-V3 671B [arXiv:2412.19437].

61 layers, d_model 7168, 128 heads with MLA (the assigned 'GQA kv=128' is
realized as MLA per the source paper), MoE: 1 shared + 256 routed experts
top-8 with expert width 2048, first 3 layers dense (d_ff 18432), MTP depth 1,
vocab 129280.  Optimizer is SGD for the dry-run: Adam state for 671B params
does not fit 256 × 16 GB (DESIGN.md §5).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=18432,
        vocab_size=129280,
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                      d_ff_expert=2048, first_dense_layers=3,
                      dense_d_ff=18432),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        mtp_depth=1,
        optimizer="sgd",
        grad_accum=8,
        source="arXiv:2412.19437",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-reduced",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        mlp="swiglu",
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      d_ff_expert=128, first_dense_layers=1, dense_d_ff=512),
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        mtp_depth=1,
        dtype="float32",
        optimizer="sgd",
        source="arXiv:2412.19437 (reduced)",
    )
