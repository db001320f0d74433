"""Attention of the LM path (counterpart of ``repro.models.attention``, GQA
and MHA): chunked (flash-style) softmax with RoPE / M-RoPE, sliding
windows and KV caches, ring buffers of the window size among them.

:func:`flash_attention` is the reference's computation in torch ops: f32
scores and accumulators, a running softmax over KV chunks, the chunk sizes
fitted by the reference's divisor rule and causal block skipping under
``skip_masked_blocks``. It never materializes an (S, S) score matrix. The
caches are dicts of tensors that :class:`Attention` updates in place (the
reference returns new ones). MLA (DeepSeek-V2) is not ported yet
(ROADMAP A18b).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, Init, apply_mrope, apply_rope

__all__ = ["NEG_INF", "flash_attention", "Attention", "init_kv_cache"]

# Not -inf: a wholly masked KV chunk (empty cache slots, pos = -1) then
# gives exp(0) terms that a later live chunk's correction wipes, where -inf
# would give exp(-inf - -inf) = NaN.
NEG_INF = -1e30


def _fit(chunk: int, total: int) -> int:
    """The largest divisor of ``total`` that is <= ``chunk``."""
    chunk = min(chunk, total)
    while total % chunk:
        chunk -= 1
    return chunk


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, Dv)
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Skv)
    *,
    causal: bool = True,
    window: int = 0,
    kv_valid: Optional[torch.Tensor] = None,  # (B, Skv) bool
    q_chunk: int = 512,
    kv_chunk: int = 512,
    skip_masked_blocks: bool = False,
) -> torch.Tensor:
    """Memory-efficient attention with a running softmax over KV chunks.

    ``skip_masked_blocks``: under a causal mask without a window, a query
    chunk stops at the last KV chunk that can hold one of its keys. Returns
    (B, Sq, Hq, Dv) in ``q``'s dtype. K and V may be stored at any dtype
    (a float8 cache included): each chunk is read at f32.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    cq, ck = _fit(q_chunk, Sq), _fit(kv_chunk, Skv)
    nq, nkv = Sq // cq, Skv // ck
    qs = q.float() * (1.0 / math.sqrt(D))
    outs = []
    for qi in range(nq):
        qsl = slice(qi * cq, (qi + 1) * cq)
        qb = qs[:, qsl].transpose(1, 2).reshape(B, Hkv, G, cq, D)
        qp = q_pos[:, qsl]
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, cq, Dv), dtype=torch.float32,
                          device=q.device)
        if skip_masked_blocks and causal and window == 0:
            n_live = min(((qi + 1) * cq + ck - 1) // ck, nkv)
        else:
            n_live = nkv
        for ki in range(n_live):
            ksl = slice(ki * ck, (ki + 1) * ck)
            kb = k[:, ksl].transpose(1, 2).float()  # (B, Hkv, ck, D)
            vb = v[:, ksl].transpose(1, 2).float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb)
            kp = kv_pos[:, ksl]
            mask = None
            if causal:
                mask = kp[:, None, :] <= qp[:, :, None]
            if window > 0:
                w = kp[:, None, :] > qp[:, :, None] - window
                mask = w if mask is None else mask & w
            if kv_valid is not None:
                kvm = kv_valid[:, ksl][:, None, :]
                mask = kvm if mask is None else mask & kvm
            if mask is not None:
                s = torch.where(mask[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.reshape(B, Hq, cq, Dv).transpose(1, 2))
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.to(q.dtype)


# ------------------------------------------------------------------ cache ----
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, window: int = 0) -> dict:
    """One layer's cache: K and V of (batch, size, Hkv, hd) and the position
    of each slot (-1: empty). A local-attention layer keeps a ring buffer of
    ``size = min(window, max_len)`` slots."""
    size = min(window, max_len) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
    }


def _store(dst: torch.Tensor, slots: torch.Tensor, val: torch.Tensor) -> None:
    """``dst[:, slots] = val`` rounded to ``dst``'s dtype. A float8 cache is
    written through its bytes (index assignment of float8 is not
    implemented on every device)."""
    val = val.to(dst.dtype)
    if dst.element_size() == 1 and dst.is_floating_point():
        dst, val = dst.view(torch.uint8), val.view(torch.uint8)
    dst[:, slots] = val


def _cache_write(cache: dict, k, v, positions, index: int,
                 ring: bool) -> None:
    """Write S new K/V entries and their positions at slot ``index`` on
    (modulo the size if ``ring``), in place."""
    S, size = k.shape[1], cache["k"].shape[1]
    slots = torch.arange(index, index + S, device=positions.device)
    if ring:
        slots = slots % size
    elif index + S > size:
        raise IndexError(f"cache of {size} slots cannot take entries "
                         f"{index}..{index + S - 1}")
    _store(cache["k"], slots, k)
    _store(cache["v"], slots, v)
    cache["pos"][:, slots] = positions[:, :S].to(torch.int32)


# -------------------------------------------------------------- the block ----
class Attention(nn.Module):
    """GQA / MHA with RoPE or M-RoPE; ``forward`` returns the block's output
    and updates ``cache`` in place."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        if cfg.attn_kind != "gqa":
            raise ValueError(
                f"attn_kind={cfg.attn_kind!r} is not ported: MLA waits for "
                "ROADMAP A18b")
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = Dense(d, cfg.num_heads * hd, init, cfg.qkv_bias)
        self.wk = Dense(d, cfg.num_kv_heads * hd, init, cfg.qkv_bias)
        self.wv = Dense(d, cfg.num_kv_heads * hd, init, cfg.qkv_bias)
        self.wo = Dense(cfg.num_heads * hd, d, init)

    def _rope(self, x, positions):
        cfg = self.cfg
        if cfg.pos_emb == "mrope":
            return apply_mrope(x, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        if cfg.pos_emb == "rope":
            return apply_rope(x, positions, cfg.rope_theta)
        return x

    def forward(self, x, positions, cache: Optional[dict] = None,
                cache_index: int = 0, window: int = 0, q_chunk: int = 512,
                kv_chunk: int = 512, skip_masked_blocks: bool = False):
        """x: (B, S, d); positions (B, S), or (B, S, 3) under mrope.

        Without a cache: self-attention over ``x``. A ring-buffer cache and
        S > 1 (prefill): attend over ``x`` in context, then keep its last
        ``window`` tokens. Otherwise: write the S entries at
        ``cache_index`` and attend over the cache's valid slots.
        """
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pos_1d = positions[..., 0] if positions.dim() == 3 else positions
        ring = window > 0 and cache is not None
        q = self._rope(self.wq(x).reshape(B, S, H, hd), positions)
        k = self._rope(self.wk(x).reshape(B, S, Hkv, hd), positions)
        v = self.wv(x).reshape(B, S, Hkv, hd)
        chunks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
        if cache is None or (ring and S > 1):
            out = flash_attention(q, k, v, pos_1d, pos_1d, causal=cfg.causal,
                                  window=window,
                                  skip_masked_blocks=skip_masked_blocks,
                                  **chunks)
            if cache is not None:
                # tokens early in the prefix would be overwritten before
                # their window expires: persist only the last W
                wl = min(cache["k"].shape[1], S)
                _cache_write(cache, k[:, S - wl:], v[:, S - wl:],
                             pos_1d[:, S - wl:], cache_index + S - wl,
                             ring=True)
        else:
            _cache_write(cache, k, v, pos_1d, cache_index, ring)
            out = flash_attention(q, cache["k"], cache["v"], pos_1d,
                                  cache["pos"], causal=cfg.causal,
                                  window=window, kv_valid=cache["pos"] >= 0,
                                  **chunks)
        return self.wo(out.reshape(B, S, H * hd))
