"""Deterministic synthetic batches matching each architecture's input
contract (counterpart of ``repro.data.synthetic``): tokens, audio
features, or the VLM's merged embeddings with M-RoPE positions.

The numbers are drawn exactly as the reference draws them (numpy's
``default_rng(SeedSequence([seed, step]))`` in the same order), so both
packages see bit-identical batches. Returns CPU tensors: int32 tokens,
labels and positions, f32 features and embeddings, a bool vision mask.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

__all__ = ["synthetic_batch", "synthetic_batches"]


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    step: int = 0) -> dict:
    """One deterministic batch. Learnable structure: tokens follow a noisy
    affine recurrence over the vocab, so a real model can reduce its
    loss."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    V = cfg.vocab_size
    x = np.zeros((batch, seq + 1), np.int64)
    x[:, 0] = rng.integers(0, V, batch)
    noise = rng.integers(0, 7, (batch, seq))
    for t in range(seq):
        x[:, t + 1] = (x[:, t] * 31 + 17 + noise[:, t]) % V
    out = {
        "tokens": _int32(x[:, :seq]),
        # an encoder classifies each frame: no shift
        "labels": _int32(x[:, :seq] % V if cfg.is_encoder_only
                         else x[:, 1:seq + 1]),
    }
    if cfg.frontend_stub and cfg.family == "audio":
        out["features"] = torch.from_numpy(
            rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        n_img = max(seq // 4, 1)
        vis = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
        mask = np.zeros((batch, seq), bool)
        mask[:, :n_img] = True  # image tokens lead the sequence
        out["vision_embeds"] = torch.from_numpy(vis)
        out["vision_mask"] = torch.from_numpy(mask)
        # M-RoPE positions: the image patch grid, then the text raster
        side = max(int(np.sqrt(n_img)), 1)
        idx = np.arange(seq)
        img = idx < n_img
        t_pos = np.where(img, 0, side + idx - n_img)  # text after the grid
        h_pos = np.where(img, idx // side, t_pos)
        w_pos = np.where(img, idx % side, t_pos)
        pos = np.stack([t_pos, h_pos, w_pos], axis=-1)
        out["positions"] = _int32(np.broadcast_to(pos, (batch, seq, 3)))
    return out


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0) -> Iterator[dict]:
    step = 0
    while True:
        yield synthetic_batch(cfg, batch, seq, seed=seed, step=step)
        step += 1


def _int32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
