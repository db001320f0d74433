"""The LM serving path's model stack (counterpart of ``repro.models``):
dense GQA/MHA, M-RoPE VLM and audio-encoder backbones, RG-LRU hybrids and
RWKV-6. MoE and MLA blocks wait for ROADMAP A18b."""
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
