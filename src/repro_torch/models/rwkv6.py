"""RWKV-6 "Finch" block (arXiv:2404.05892; counterpart of
``repro.models.rwkv6``): attention-free time mix with data-dependent decay,
plus squared-ReLU channel mix.

Recurrence per head (key dim = value dim = rwkv_head_dim):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

evaluated chunk by chunk as the reference does (chunk 64, fitted down to a
divisor of S): within a chunk by masked products on decay-rescaled r and
k, across chunks through the carried (B, H, D, D) f32 state. Decode keeps
that state and the two token-shift rows (time mix, channel mix) per
layer, updated in place.

With a 'model' group ``tp`` (set by
:func:`~repro_torch.distributed.sharding.distribute_model`) the block
computes the rank's ``H/tp`` contiguous heads: ``wr``, ``wk``, ``wv``,
``wg`` and the decay's channels (``w0``, ``u``, ``w_lora_b``) give them,
the recurrence runs on them with the rank's state, and ``wo`` is
row-parallel. The channel mix takes the rank's ``d_ff/tp`` columns of
``cm_k`` and rows of ``cm_v``, and its rows of ``cm_r`` on its slice of
the mixed input: two row-parallel products, each summed over 'model'
(reduce-scattered to the rank's positions under sequence parallelism,
where the sigmoid gate meets the value on those positions). The token
shifts stay whole.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.actsharding import shard_act
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     enter_tp, rwkv_splits)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, Init

__all__ = ["LORA_RANK", "RWKV6", "init_rwkv_state"]

LORA_RANK = 32


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device,
                    tp: int = 1) -> dict:
    """Zero WKV state ``S`` (B, H, D, D) f32 and token-shift rows (B, d);
    ``tp``: the state of one rank of a 'model' axis of that many ranks,
    ``H/tp`` heads of ``S`` where the block splits."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    H = d // hd // (tp if rwkv_splits(cfg, tp) else 1)
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                         device=device),
        "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x, prev):
    """(B, S, d) -> the previous token of each position, seeded by ``prev``
    (B, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_chunked(r, k, v, w, u, chunk: int, S0):
    """Chunked evaluation of the RWKV recurrence.

    r, k, v: (B, S, H, D); w: (B, S, H, D) decay in (0, 1); u: (H, D);
    S0: (B, H, D, D). Returns (out (B, S, H, D) at r's dtype, S_final f32).
    """
    B, S, H, D = r.shape
    while S % chunk:
        chunk -= 1
    n = S // chunk

    def chunks(x):  # (n, B, H, c, D), batch on DP and heads on TP
        y = x.reshape(B, n, chunk, H, D).permute(1, 0, 3, 2, 4)
        return shard_act(y, None, "dp", "model", None, None)

    r_, k_, v_ = (chunks(x).float() for x in (r, k, v))
    logw = torch.log(torch.clamp(chunks(w).float(), 1e-8, 1.0))
    logw = shard_act(logw, None, "dp", "model", None, None)
    cum = torch.cumsum(logw, dim=3)  # log P_t, P_t = prod_{tau<=t} w_tau
    cum = shard_act(cum, None, "dp", "model", None, None)
    past = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    state = S0.float()
    outs = []
    for i in range(n):
        rf, kf, vf, cumc = r_[i], k_[i], v_[i], cum[i]
        r_hat = rf * torch.exp(cumc - logw[i])  # r_t P_{t-1}
        k_hat = kf * torch.exp(-cumc)  # k_s / P_s
        o = torch.einsum("bhtd,bhde->bhte", r_hat, state)
        att = torch.einsum("bhtd,bhsd->bhts", r_hat, k_hat)
        att = torch.where(past, att, 0.0)  # strictly past tokens
        o = o + torch.einsum("bhts,bhse->bhte", att, vf)
        bonus = (rf * u[:, None] * kf).sum(-1)  # r_t diag(u) k_tᵀ
        o = o + bonus[..., None] * vf
        p_end = cumc[:, :, -1:, :]
        k_tail = kf * torch.exp(p_end - cumc)
        state = state * torch.exp(p_end.squeeze(2))[..., None] + torch.einsum(
            "bhtd,bhte->bhde", k_tail, vf)
        outs.append(o)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, D)
    return out.to(r.dtype), state


class RWKV6(nn.Module):
    """Time mix (``forward``) and channel mix (``channel_mix``) of one
    RWKV-6 layer; its block has no separate MLP."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        self.tp: Optional[TensorParallel] = None
        d = cfg.d_model
        self.wr = Dense(d, d, init)
        self.wk = Dense(d, d, init)
        self.wv = Dense(d, d, init)
        self.wg = Dense(d, d, init)
        self.wo = Dense(d, d, init)
        # data-dependent decay: w_t = exp(-exp(w0 + lora(x)))
        self.w0 = init.full((d,), -6.0)
        self.w_lora_a = Dense(d, LORA_RANK, init)
        self.w_lora_b = Dense(LORA_RANK, d, init, scale=0.01)
        self.u = init.full((d,), 0.0)  # per-channel bonus
        # token-shift mix coefficients (static part of ddlerp)
        self.mix_r = init.full((d,), 0.5)
        self.mix_k = init.full((d,), 0.5)
        self.mix_v = init.full((d,), 0.5)
        self.mix_w = init.full((d,), 0.5)
        # channel mix
        self.cm_mix = init.full((d,), 0.5)
        self.cm_k = Dense(d, cfg.d_ff, init)
        self.cm_v = Dense(cfg.d_ff, d, init)
        self.cm_r = Dense(d, d, init)

    def forward(self, x, state: Optional[dict] = None, chunk: int = 64):
        """Time mix. x: (B, S, d), already normed; ``state`` updated in
        place (its ``shift_cm`` left to :meth:`channel_mix`), or None."""
        B, S, d = x.shape
        tp, n = self.tp, self.tp.size if self.tp is not None else 1
        hd = self.cfg.rwkv_head_dim
        H = d // hd // n  # the rank's heads
        st = state or init_rwkv_state(self.cfg, B, x.dtype, x.device, n)
        x = enter_tp(x, tp)
        prev = _token_shift(x, st["shift_tm"].to(x.dtype))

        def mix(m):
            return x * m + prev * (1 - m)

        r = self.wr(mix(self.mix_r)).reshape(B, S, H, hd)
        k = self.wk(mix(self.mix_k)).reshape(B, S, H, hd)
        v = self.wv(mix(self.mix_v)).reshape(B, S, H, hd)
        g = self.wg(x)
        w_log = self.w0.float() + self.w_lora_b(
            torch.tanh(self.w_lora_a(mix(self.mix_w)))).float()
        w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, hd)
        u = self.u.float().reshape(H, hd)
        out, s_fin = _wkv_chunked(r, k, v, w, u, chunk, st["S"])
        y = self.wo(out.reshape(B, S, H * hd) * F.silu(g), tp)
        if state is not None:
            state["S"].copy_(s_fin)
            state["shift_tm"].copy_(x[:, -1])
        return y

    def channel_mix(self, x, state: Optional[dict] = None):
        """Squared-ReLU channel mix with token shift."""
        tp = self.tp
        x = enter_tp(x, tp)
        prev = (_token_shift(x, state["shift_cm"].to(x.dtype))
                if state is not None else
                _token_shift(x, torch.zeros_like(x[:, 0])))
        m = self.cm_mix
        xk = x * m + prev * (1 - m)
        kk = torch.relu(self.cm_k(xk)).square()
        xr = xk
        if tp is not None:  # cm_r's rows: the rank's slice of its input
            w = xk.shape[-1] // tp.size
            xr = xk.narrow(-1, tp.rank * w, w)
        y = torch.sigmoid(self.cm_r(xr, tp)) * self.cm_v(kk, tp)
        if state is not None:
            state["shift_cm"].copy_(x[:, -1])
        return y
