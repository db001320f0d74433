"""The LM serving path's model stack (counterpart of ``repro.models``):
dense GQA/MHA, M-RoPE VLM and audio-encoder backbones, RG-LRU hybrids,
RWKV-6, MoE layers (GShard and sort dispatch, shared experts) and MLA."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LanguageModel,
    default_positions,
    forward,
    init_cache,
)

__all__ = [
    "LanguageModel",
    "ModelConfig",
    "default_positions",
    "forward",
    "init_cache",
]
