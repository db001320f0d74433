"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=88,
        d_model=12288,
        d_ff=28672,
        vocab_size=32768,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        attn_kind="gqa",
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        attn_kind="gqa",
        mlp_kind="swiglu",
        dtype="float32",
        param_dtype="float32",
    )


register("mistral-large-123b", config, smoke_config)
