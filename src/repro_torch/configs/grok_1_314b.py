"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        d_ff=32768,
        vocab_size=131072,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        attn_kind="gqa",
        mlp_kind="swiglu",
        num_experts=8,
        top_k=2,
        moe_d_ff=32768,
        capacity_factor=1.25,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        attn_kind="gqa",
        mlp_kind="swiglu",
        num_experts=4,
        top_k=2,
        moe_d_ff=64,
        capacity_factor=2.0,
        dtype="float32",
        param_dtype="float32",
    )


register("grok-1-314b", config, smoke_config)
