"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
— encoder-only (bidirectional), masked-frame classification head
[arXiv:2106.07447]. The conv waveform frontend is a stub: a batch's
``features`` carry precomputed frame embeddings. No decode shapes (encoder-only)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        d_ff=5120,
        vocab_size=504,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        attn_kind="gqa",
        causal=False,
        pos_emb="none",  # conv positional frontend is part of the stub
        mlp_kind="gelu",
        mlp_bias=True,
        norm="layernorm",
        frontend_stub=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=32,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        attn_kind="gqa",
        causal=False,
        pos_emb="none",
        mlp_kind="gelu",
        mlp_bias=True,
        norm="layernorm",
        frontend_stub=True,
        dtype="float32",
        param_dtype="float32",
    )


register("hubert-xlarge", config, smoke_config)
