"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892].
Sub-quadratic: runs the long_500k shape (O(1) matrix state per layer)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        d_ff=7168,
        vocab_size=65536,
        attn_kind="none",
        layer_pattern=("rwkv6",),
        rwkv_head_dim=64,
        pos_emb="none",
        norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        attn_kind="none",
        layer_pattern=("rwkv6",),
        rwkv_head_dim=16,
        pos_emb="none",
        norm="layernorm",
        dtype="float32",
        param_dtype="float32",
    )


register("rwkv6-1.6b", config, smoke_config)
