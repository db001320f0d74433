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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, Init, gelu

__all__ = ["C_EXP", "RGLRU", "init_rglru_state"]

C_EXP = 8.0


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.lru_width
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
        B = x.shape[0]
        st = state or init_rglru_state(self.cfg, B, x.dtype, x.device)
        gate = gelu(self.w_gate_in(x))
        u, conv_carry = _causal_conv(self.w_in(x), self.conv_w, self.conv_b,
                                     st["conv"])
        r = torch.sigmoid(self.wa(u).float())
        i = torch.sigmoid(self.wx(u).float())
        a = torch.exp(C_EXP * r * F.logsigmoid(self.lam.float()))
        drive = torch.sqrt(torch.clamp(1.0 - a.square(), 1e-12, 1.0)) * (
            i * u.float())
        h = _lru_scan(a, drive, st["h"])
        y = self.w_out(h.to(x.dtype) * gate)
        if state is not None:
            state["h"].copy_(h[:, -1])
            state["conv"].copy_(conv_carry)
        return y
