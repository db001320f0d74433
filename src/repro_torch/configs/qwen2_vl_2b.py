"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision frontend is a stub (a batch's ``vision_embeds``
carry precomputed patch embeddings, merged at the embedding layer). head_dim=128,
M-RoPE half-dim 64 split (t,h,w) = (16, 24, 24) as in the released model.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        d_ff=8960,
        vocab_size=151936,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        attn_kind="gqa",
        qkv_bias=True,
        pos_emb="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        mlp_kind="swiglu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        attn_kind="gqa",
        qkv_bias=True,
        pos_emb="mrope",
        mrope_sections=(2, 3, 3),
        mlp_kind="swiglu",
        tie_embeddings=True,
        dtype="float32",
        param_dtype="float32",
    )


register("qwen2-vl-2b", config, smoke_config)
