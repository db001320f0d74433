"""Serving steps (counterpart of ``repro.train.serve_step``): prefill
builds the caches from a prompt batch, decode runs one new token against
them, and :func:`greedy_generate` loops the two. The caches are updated in
place (the reference donates them)."""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from repro_torch.models.model import LanguageModel, init_cache

__all__ = ["make_prefill_step", "make_decode_step", "greedy_generate"]


def make_prefill_step(model: LanguageModel, attn_args: Optional[dict] = None):
    """prefill(batch, cache) -> (last_logits (B, V), cache)."""

    @torch.inference_mode()
    def prefill(batch, cache):
        logits, cache = model(batch, cache, 0, attn_args=attn_args,
                              last_only=True)
        return logits[:, -1, :], cache

    return prefill


def make_decode_step(model: LanguageModel, attn_args: Optional[dict] = None):
    """decode(tokens (B, 1), cache, index) -> (logits (B, V), cache);
    ``index`` is the new token's position (a Python int)."""

    @torch.inference_mode()
    def decode(tokens, cache, index: int):
        logits, cache = model({"tokens": tokens}, cache, index,
                              attn_args=attn_args)
        return logits[:, 0, :], cache

    return decode


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_generate(model: LanguageModel, prompt: torch.Tensor, steps: int,
                    max_len: Optional[int] = None, *,
                    all_logits: bool = False,
                    timings: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding on the model's device. Returns (generated (B, steps)
    int32, logits): the last step's (B, V), or with ``all_logits`` every
    step's (B, steps, V) (step t predicts token t).

    ``timings``, if given, receives ``prefill_s`` and ``decode_s`` (host
    seconds, each ended by a device synchronize)."""
    dev = model.device
    prompt = prompt.to(dev)
    B, S = prompt.shape
    max_len = max_len or (S + steps)
    cache = init_cache(model.cfg, B, max_len, dev)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    t0 = time.perf_counter()
    logits, cache = prefill({"tokens": prompt}, cache)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["prefill_s"] = t1 - t0
    kept = [logits] if all_logits else None
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    for t in range(steps - 1):
        logits, cache = decode(tok, cache, S + t)
        if all_logits:
            kept.append(logits)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
    if timings is not None:
        _sync(dev)
        timings["decode_s"] = time.perf_counter() - t1
    return (torch.cat(out, dim=1),
            torch.stack(kept, dim=1) if all_logits else logits)
