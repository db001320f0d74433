"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40 => MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen; hf]."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        d_ff=27392,
        vocab_size=152064,
        num_heads=40,
        num_kv_heads=40,
        head_dim=128,
        attn_kind="gqa",
        qkv_bias=True,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
        # MHA (kv=40): the bf16 decode_32k cache alone is 5.5 TB > fleet
        # HBM; fp8 KV cache halves it under the 16 GB/chip budget.
        cache_dtype="float8_e4m3fn",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        attn_kind="gqa",
        qkv_bias=True,
        mlp_kind="swiglu",
        dtype="float32",
        param_dtype="float32",
    )


register("qwen1.5-32b", config, smoke_config)
