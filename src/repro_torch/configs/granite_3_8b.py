"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA [hf:ibm-granite; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        d_ff=12800,
        vocab_size=49155,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        attn_kind="gqa",
        mlp_kind="swiglu",
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke",
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
        tie_embeddings=True,
        dtype="float32",
        param_dtype="float32",
    )


register("granite-3-8b", config, smoke_config)
