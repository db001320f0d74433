"""Gradient compression for slow cross-group reductions (counterpart of
``repro.distributed.compression``). Two schemes, applied through
``TrainConfig.grad_transform`` to a dict of gradients:

  * bf16 cast (2x): cast down and back, what a bf16 all-reduce keeps;
  * int8 with a per-tensor scale (4x) and error feedback: the quantizer's
    residual is carried in a state dict and added back the next step, so
    the sum of the compressed gradients tracks the true sum.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["bf16_compress", "make_int8_error_feedback"]


def bf16_compress(grads: dict) -> dict:
    """Simulate a bf16 all-reduce: cast down, cast back."""
    return {n: g.to(torch.bfloat16).to(g.dtype) for n, g in grads.items()}


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def make_int8_error_feedback(params_template: dict
                             ) -> Tuple[Callable, dict]:
    """Returns ``(transform(grads, state) -> (grads, state), state0)``; the
    state is an f32 residual per parameter, zero to start."""
    state0 = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params_template.items()}

    def transform(grads: dict, state: dict):
        new_grads, new_state = {}, {}
        for n, g in grads.items():
            total = g.float() + state[n]
            q = _int8_roundtrip(total).to(g.dtype)
            new_grads[n] = q
            new_state[n] = total - q.float()
        return new_grads, new_state

    return transform, state0
