"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18432,
        d_ff=73728,
        vocab_size=256_000,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        attn_kind="gqa",
        mlp_kind="squared_relu",
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        d_ff=192,
        vocab_size=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=24,
        attn_kind="gqa",
        mlp_kind="squared_relu",
        dtype="float32",
        param_dtype="float32",
    )


register("nemotron-4-340b", config, smoke_config)
