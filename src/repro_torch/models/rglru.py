"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
counterpart of ``repro.models.rglru``).

    r_t = σ(W_a x_t + b_a)            (recurrence gate)
    i_t = σ(W_x x_t + b_x)            (input gate)
    a_t = a^(c·r_t),  a = σ(Λ)        (data-dependent diagonal decay, c=8)
    h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)

preceded by a depthwise causal conv1d (width 4) and wrapped by in/out
projections with a tanh-GeLU gate. The diagonal recurrence is evaluated in
f32 by a log-depth (Hillis–Steele) scan over time: ceil(log2 S) steps of
whole-sequence products, where the reference runs ``associative_scan``;
both are exact evaluations of the same recurrence and differ by rounding.
Decode carries ``(h, conv window)`` per layer, updated in place.

With a 'model' group ``tp`` (set by
:func:`~repro_torch.distributed.sharding.distribute_model`) the block
computes the rank's ``w/tp`` contiguous channels: ``w_in`` and
``w_gate_in`` give them, the conv, the decay, the scan and the gate run on
them, ``u`` is all-gathered along the width for the rank's columns of the
full ``wa`` and ``wx``, and ``w_out`` is row-parallel. Its state holds the
rank's channels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     copy_to_tp, enter_tp,
                                                     gather_from_tp,
                                                     rglru_splits)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, Init, gelu

__all__ = ["C_EXP", "RGLRU", "init_rglru_state"]

C_EXP = 8.0


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device,
                     tp: int = 1) -> dict:
    """Zero ``h`` (B, w) f32 and conv window (B, cw-1, w); ``tp``: the
    state of one rank of a 'model' axis of that many ranks, ``w/tp`` of
    the channels where the block splits."""
    w = cfg.lru_width // (tp if rglru_splits(cfg, tp) else 1)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }


def _causal_conv(x, w, b, carry):
    """Depthwise causal conv1d. x: (B, S, w); carry: (B, cw-1, w)."""
    cw, S = w.shape[0], x.shape[1]
    xp = torch.cat([carry.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + S, :] * w[i]
    new_carry = xp[:, -(cw - 1):, :] if cw > 1 else carry
    return out + b, new_carry


def _lru_scan(a, u, h0):
    """h_t = a_t ⊙ h_{t-1} + u_t, h_{-1} = h0. a, u: (B, S, w) f32."""
    h = u.clone()
    h[:, 0] += a[:, 0] * h0
    off, S = 1, a.shape[1]
    while off < S:
        h = torch.cat([h[:, :off], a[:, off:] * h[:, :-off] + h[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return h


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        self.tp: Optional[TensorParallel] = None
        d, w = cfg.d_model, cfg.lru_width
        self.w_in = Dense(d, w, init)  # recurrent branch input
        self.w_gate_in = Dense(d, w, init)  # gelu gate branch
        self.w_out = Dense(w, d, init)
        self.conv_w = init.normal((cfg.conv_width, w), 0.1)
        self.conv_b = init.full((w,), 0.0)
        self.wa = Dense(w, w, init)
        self.wx = Dense(w, w, init)
        # Λ so that a = σ(Λ) spans (0.9, 0.999), as in the paper
        p = np.linspace(0.9, 0.999, w, dtype=np.float32)
        self.lam = init.tensor(torch.from_numpy(np.log(p / (1 - p))))

    def forward(self, x, state: Optional[dict] = None):
        """x: (B, S, d), already normed. ``state`` (updated in place) or
        None for fresh zeros, discarded."""
        B, tp = x.shape[0], self.tp
        st = state or init_rglru_state(self.cfg, B, x.dtype, x.device,
                                       tp.size if tp is not None else 1)
        x = enter_tp(x, tp)
        gate = gelu(self.w_gate_in(x))
        u, conv_carry = _causal_conv(self.w_in(x), self.conv_w, self.conv_b,
                                     st["conv"])
        # every channel of u for the rank's gate columns; its gradient
        # summed over 'model' before the rank's slice is cut
        u_all = copy_to_tp(gather_from_tp(u, tp), tp)
        r = torch.sigmoid(self.wa(u_all).float())
        i = torch.sigmoid(self.wx(u_all).float())
        a = torch.exp(C_EXP * r * F.logsigmoid(self.lam.float()))
        drive = torch.sqrt(torch.clamp(1.0 - a.square(), 1e-12, 1.0)) * (
            i * u.float())
        h = _lru_scan(a, drive, st["h"])
        y = self.w_out(h.to(x.dtype) * gate, tp)
        if state is not None:
            state["h"].copy_(h[:, -1])
            state["conv"].copy_(conv_carry)
        return y
