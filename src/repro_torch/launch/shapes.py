"""The input-shape grid of the LM cells and each (arch, shape)'s input and
cache stand-ins (counterpart of ``repro.launch.shapes``).

The stand-ins are tensors on the ``meta`` device: shapes and dtypes, no
storage. The dry-run (:mod:`repro_torch.launch.dryrun`) counts every cell
of the grid and runs the ones that fit one card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES

__all__ = ["ShapeCase", "SHAPES", "input_specs", "applicable_shapes",
           "cache_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The reference's skip rules: encoder-only archs have no decode step,
    and only sub-quadratic archs take ``long_500k``."""
    out = ["train_4k", "prefill_32k"]
    if cfg.is_encoder_only:
        return out
    out.append("decode_32k")
    if cfg.is_subquadratic:
        out.append("long_500k")
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCase) -> dict:
    """Model-input stand-ins for one grid cell, under the reference's keys.

    train:   full (B, S) token/label batch (+ frontend stubs).
    prefill: (B, S) prompt tokens.
    decode:  (B, 1) new token; the cache comes from :func:`cache_specs`.
    """
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    act = DTYPES[cfg.dtype]
    specs = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
        specs["loss_mask"] = _meta((B, S), torch.float32)
    if cfg.frontend_stub and cfg.family == "audio":
        specs["features"] = _meta((B, S, cfg.d_model), act)
    if cfg.family == "vlm":
        if shape.kind != "decode":
            specs["vision_embeds"] = _meta((B, S, cfg.d_model), act)
            specs["vision_mask"] = _meta((B, S), torch.bool)
        specs["positions"] = _meta((B, S, 3), torch.int32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeCase) -> Optional[list]:
    """The cache at this shape (prefill / decode): the port's one dict a
    layer from ``models.init_cache`` on the ``meta`` device, which
    allocates nothing. ``None`` for train cells."""
    if shape.kind == "train":
        return None
    from repro_torch.models import init_cache

    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
