"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400 — MLA (kv_lora=512, q_lora=1536, nope=128, rope=64, v=128),
MoE 2 shared + 160 routed top-6, first layer dense (d_ff=12288)
[arXiv:2405.04434; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        d_ff=12288,  # dense first layer
        vocab_size=102400,
        num_heads=128,
        attn_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mlp_kind="swiglu",
        num_experts=160,
        num_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        first_dense_layers=1,
        capacity_factor=1.0,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        num_heads=4,
        attn_kind="mla",
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        mlp_kind="swiglu",
        num_experts=8,
        num_shared_experts=2,
        top_k=2,
        moe_d_ff=32,
        first_dense_layers=1,
        capacity_factor=2.0,
        dtype="float32",
        param_dtype="float32",
    )


register("deepseek-v2-236b", config, smoke_config)
