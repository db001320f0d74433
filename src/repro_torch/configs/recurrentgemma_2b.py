"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rglru, rglru, attn) 1:2
[arXiv:2402.19427; hf]. Sub-quadratic: runs the long_500k shape (local
window 2048 ring cache + O(1) recurrent state)."""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        d_ff=7680,
        vocab_size=256_000,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        attn_kind="gqa",
        layer_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        lru_width=2560,
        conv_width=4,
        mlp_kind="geglu",
        pos_emb="rope",
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        attn_kind="gqa",
        layer_pattern=("rglru", "rglru", "attn"),
        local_window=16,
        lru_width=64,
        conv_width=4,
        mlp_kind="geglu",
        tie_embeddings=True,
        dtype="float32",
        param_dtype="float32",
    )


register("recurrentgemma-2b", config, smoke_config)
