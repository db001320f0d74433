"""Attention of the LM path (counterpart of ``repro.models.attention``):
chunked (flash-style) GQA / MHA with RoPE / M-RoPE, sliding windows and KV
caches, ring buffers of the window size among them, and DeepSeek-V2's
multi-head latent attention (MLA).

:func:`flash_attention` is the reference's computation in torch ops: f32
scores and accumulators, a running softmax over KV chunks, the chunk sizes
fitted by the reference's divisor rule and causal block skipping under
``skip_masked_blocks``. It never materializes an (S, S) score matrix. The
caches are dicts of tensors that :class:`Attention` and
:class:`MLAttention` update in place (the reference returns new ones).
MLA caches the compressed ``ckv`` and the shared ``krope`` of each token
(576 values for deepseek-v2) and attends in that space with the key and
value up-projections absorbed into the query and the output; without a
cache it expands K and V per head.

A placed rank's cache may hold a block of the slots alone
(:class:`CacheBlock`, the rule in
:mod:`repro_torch.distributed.tensor_parallel`): the module's slot group
(``slots``) then merges the ranks' partial softmaxes wherever the queries
attend the cache, and a prefill into a fresh cache attends the prompt in
context.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.actsharding import shard_act
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     combine_over_slots,
                                                     enter_tp, gather_heads,
                                                     local_kv_heads,
                                                     slot_block,
                                                     slot_group_size)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Dense, Init, apply_mrope, apply_rope,
                                      rms_norm)

__all__ = ["NEG_INF", "flash_attention", "Attention", "MLAttention",
           "CacheBlock", "init_kv_cache"]

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
    scale: Optional[float] = None,
    skip_masked_blocks: bool = False,
    partial: bool = False,
):
    """Memory-efficient attention with a running softmax over KV chunks.

    ``scale`` multiplies the queries (default ``1/sqrt(D)``; MLA passes
    ``1/sqrt(dn + dr)`` whatever width its queries have).

    ``skip_masked_blocks``: under a causal mask without a window, a query
    chunk stops at the last KV chunk that can hold one of its keys. Returns
    (B, Sq, Hq, Dv) in ``q``'s dtype. K and V may be stored at any dtype
    (a float8 cache included): each chunk is read at f32.

    ``partial``: the softmax's state instead, before the division and the
    cast: ``(acc, m, l)``, the f32 numerator (B, Sq, Hq, Dv), the running
    max and the sum (B, Sq, Hq), for a merge with other KV blocks'
    (:func:`~repro_torch.distributed.tensor_parallel.combine_over_slots`).
    Where no key was valid, ``m`` stays at ``NEG_INF``.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    cq, ck = _fit(q_chunk, Sq), _fit(kv_chunk, Skv)
    nq, nkv = Sq // cq, Skv // ck
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # batch on DP, heads on TP for the whole chunk loop: every chunk slices
    # the one placed buffer
    q = shard_act(q, "dp", None, "model", None)
    k = shard_act(k, "dp", None, "model", None)
    v = shard_act(v, "dp", None, "model", None)
    qs = q.float() * scale
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
        if partial:
            outs.append((acc.reshape(B, Hq, cq, Dv).transpose(1, 2),
                         m.reshape(B, Hq, cq).transpose(1, 2),
                         l.reshape(B, Hq, cq).transpose(1, 2)))
            continue
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.reshape(B, Hq, cq, Dv).transpose(1, 2))
    if partial:
        return tuple(torch.cat(x, dim=1) for x in zip(*outs))
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.to(q.dtype)


# ------------------------------------------------------------------ cache ----
class CacheBlock(dict):
    """An attention layer's cache (its tensors by name) that holds the
    block ``[first, first + n)`` of the layer's ``size`` slots alone, n
    its tensors' axis 1: a placed rank's share along the slots."""

    def __init__(self, tensors: dict, first: int, size: int):
        super().__init__(tensors)
        self.first, self.size = first, size


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, window: int = 0, tp: int = 1,
                  rank: int = 0) -> dict:
    """One layer's cache: K and V of (batch, size, Hkv, hd) and the position
    of each slot (-1: empty). A local-attention layer keeps a ring buffer of
    ``size = min(window, max_len)`` slots. MLA keeps the compressed ``ckv``
    (batch, size, kv_lora_rank) and ``krope`` (batch, size, rope dim).
    ``tp``, ``rank``: the rank at ``rank`` of a 'model' axis of ``tp``
    ranks, whose split attention holds only its own KV heads
    (:func:`~repro_torch.distributed.tensor_parallel.local_kv_heads`) and
    whose slot group holds its block of the slots alone (a
    :class:`CacheBlock`; the whole ``size`` where it does not divide)."""
    size = min(window, max_len) if window else max_len
    first, n = slot_block(size, slot_group_size(cfg, tp), rank)
    if cfg.attn_kind == "mla":
        out = {
            "ckv": torch.zeros((batch, n, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, n, cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device),
        }
    else:
        shape = (batch, n, local_kv_heads(cfg, tp), cfg.head_dim)
        out = {"k": torch.zeros(shape, dtype=dtype, device=device),
               "v": torch.zeros(shape, dtype=dtype, device=device)}
    out["pos"] = torch.full((batch, n), -1, dtype=torch.int32, device=device)
    return out if n == size else CacheBlock(out, first, size)


def _size(cache: dict) -> int:
    """The layer's slots, the whole of them where the cache holds a
    block."""
    return (cache.size if isinstance(cache, CacheBlock)
            else cache["pos"].shape[1])


def _store(dst: torch.Tensor, slots: torch.Tensor, val: torch.Tensor) -> None:
    """``dst[:, slots] = val`` rounded to ``dst``'s dtype. A float8 cache is
    written through its bytes (index assignment of float8 is not
    implemented on every device)."""
    val = val.to(dst.dtype)
    if dst.element_size() == 1 and dst.is_floating_point():
        dst, val = dst.view(torch.uint8), val.view(torch.uint8)
    dst[:, slots] = val


def _cache_write(cache: dict, names, values, positions, index: int,
                 ring: bool) -> None:
    """Write S new entries of each cache entry in ``names`` (``values`` in
    the same order) and their positions at slot ``index`` on (modulo the
    size if ``ring``), in place. A :class:`CacheBlock` takes those that
    land in its block alone."""
    S, size = values[0].shape[1], _size(cache)
    slots = torch.arange(index, index + S, device=positions.device)
    if ring:
        slots = slots % size
    elif index + S > size:
        raise IndexError(f"cache of {size} slots cannot take entries "
                         f"{index}..{index + S - 1}")
    positions = positions[:, :S]
    if isinstance(cache, CacheBlock):  # the entries of the rank's slots
        n = cache["pos"].shape[1]
        mine = ((slots >= cache.first) & (slots < cache.first + n)).cpu()
        keep = torch.nonzero(mine).flatten().to(positions.device)
        slots = slots[keep] - cache.first
        values = [val.index_select(1, keep) for val in values]
        positions = positions.index_select(1, keep)
    for name, val in zip(names, values):
        _store(cache[name], slots, val)
    cache["pos"][:, slots] = positions.to(torch.int32)


def _attend_slots(q, k, v, q_pos, cache: CacheBlock, slots: TensorParallel,
                  heads_split: bool, **kwargs) -> torch.Tensor:
    """The queries ``q`` attend the slot group's cache through the rank's
    block (K ``k``, V ``v``, positions ``cache["pos"]``): the group's
    queries all-gathered along heads where its ranks hold other heads
    (``heads_split``), the rank's partial softmax, then the group's merge
    to the rank's heads, cast to ``q``'s dtype."""
    qg = gather_heads(q, slots) if heads_split else q
    acc, m, l = flash_attention(qg, k, v, q_pos, cache["pos"],
                                kv_valid=cache["pos"] >= 0, partial=True,
                                **kwargs)
    return combine_over_slots(acc, m, l, slots,
                              scatter=heads_split).to(q.dtype)


# ------------------------------------------------------------- the blocks ----
def _rope(cfg: ModelConfig, x, positions):
    if cfg.pos_emb == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if cfg.pos_emb == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    return x


class Attention(nn.Module):
    """GQA / MHA with RoPE or M-RoPE; ``forward`` returns the block's output
    and updates ``cache`` in place.

    With a 'model' group ``tp`` (set by
    :func:`~repro_torch.distributed.sharding.distribute_model`) the weights
    are the rank's: ``wq`` its ``H/tp`` contiguous query heads, ``wk`` and
    ``wv`` the KV heads those use, ``wo`` their rows (row-parallel), and the
    cache holds those KV heads. With a slot group ``slots`` (set there
    too) a cache that holds the rank's block of the slots is attended
    through the group's merge."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        if cfg.attn_kind != "gqa":
            raise ValueError(f"attn_kind={cfg.attn_kind!r}: Attention is GQA "
                             "/ MHA (MLA is MLAttention)")
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = Dense(d, cfg.num_heads * hd, init, cfg.qkv_bias)
        self.wk = Dense(d, cfg.num_kv_heads * hd, init, cfg.qkv_bias)
        self.wv = Dense(d, cfg.num_kv_heads * hd, init, cfg.qkv_bias)
        self.wo = Dense(cfg.num_heads * hd, d, init)
        self.tp: Optional[TensorParallel] = None
        self.slots: Optional[TensorParallel] = None

    def forward(self, x, positions, cache: Optional[dict] = None,
                cache_index: int = 0, window: int = 0, q_chunk: int = 512,
                kv_chunk: int = 512, skip_masked_blocks: bool = False):
        """x: (B, S, d); positions (B, S), or (B, S, 3) under mrope.

        Without a cache: self-attention over ``x``. A ring-buffer cache and
        S > 1 (prefill): attend over ``x`` in context, then keep its last
        ``window`` tokens. Otherwise: write the S entries at
        ``cache_index`` and attend over the cache's valid slots. A
        :class:`CacheBlock` at ``cache_index`` 0 attends the entries in
        context, rounded to the cache's dtype as the cache would hold
        them, and keeps those of its slots; at a later index the group
        merges the ranks' blocks.
        """
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if self.tp is not None:  # this rank's heads
            x = enter_tp(x, self.tp)
            H, Hkv = H // self.tp.size, local_kv_heads(cfg, self.tp.size)
        pos_1d = positions[..., 0] if positions.dim() == 3 else positions
        ring = window > 0 and cache is not None
        q = shard_act(_rope(cfg, self.wq(x).reshape(B, S, H, hd), positions),
                      "dp", None, "model", None)
        k = shard_act(_rope(cfg, self.wk(x).reshape(B, S, Hkv, hd),
                            positions), "dp", None, "model", None)
        v = shard_act(self.wv(x).reshape(B, S, Hkv, hd),
                      "dp", None, "model", None)
        chunks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
        if cache is None or (ring and S > 1):
            out = flash_attention(q, k, v, pos_1d, pos_1d, causal=cfg.causal,
                                  window=window,
                                  skip_masked_blocks=skip_masked_blocks,
                                  **chunks)
            if cache is not None:
                # tokens early in the prefix would be overwritten before
                # their window expires: persist only the last W
                wl = min(_size(cache), S)
                _cache_write(cache, ("k", "v"), (k[:, S - wl:], v[:, S - wl:]),
                             pos_1d[:, S - wl:], cache_index + S - wl,
                             ring=True)
        elif isinstance(cache, CacheBlock) and cache_index == 0:
            dt = cache["k"].dtype
            out = flash_attention(q, k.to(dt), v.to(dt), pos_1d, pos_1d,
                                  causal=cfg.causal, window=window, **chunks)
            _cache_write(cache, ("k", "v"), (k, v), pos_1d, cache_index, ring)
        elif isinstance(cache, CacheBlock):
            _cache_write(cache, ("k", "v"), (k, v), pos_1d, cache_index, ring)
            out = _attend_slots(q, cache["k"], cache["v"], pos_1d, cache,
                                self.slots, self.tp is not None,
                                causal=cfg.causal, window=window, **chunks)
        else:
            _cache_write(cache, ("k", "v"), (k, v), pos_1d, cache_index, ring)
            out = flash_attention(q, cache["k"], cache["v"], pos_1d,
                                  cache["pos"], causal=cfg.causal,
                                  window=window, kv_valid=cache["pos"] >= 0,
                                  **chunks)
        return self.wo(out.reshape(B, S, H * hd), self.tp)


class MLAttention(nn.Module):
    """DeepSeek-V2 multi-head latent attention (the reference's
    ``_mla_block``); ``forward`` returns the block's output and updates
    ``cache`` in place.

    The parameters keep the reference's names: ``wq_a``, ``q_norm_scale``
    (with a query rank), ``wq_b``, ``wkv_a``, ``kv_norm_scale``, ``wk_b``,
    ``wv_b``, ``wo``. Without a cache K and V are expanded per head (every
    head sharing the one RoPE'd key part); with one, prefill included, the
    compressed entries are written and the queries attend in their space:
    ``wk_b`` absorbed into the query, ``wv_b`` applied to the context.
    Both modes scale the scores by ``1/sqrt(dn + dr)``.

    With a 'model' group ``tp`` (set by
    :func:`~repro_torch.distributed.sharding.distribute_model`) ``wq_b``,
    ``wk_b`` and ``wv_b`` are the rank's ``H/tp`` contiguous heads and
    ``wo`` their rows (row-parallel); ``wq_a``, ``wkv_a`` and the norms are
    whole, and their outputs enter the rank's heads through
    :func:`~repro_torch.distributed.tensor_parallel.copy_to_tp`. The
    compressed cache is every head's: every 'model' rank computes it
    whole, so its slot group (``slots``) is the axis and each rank holds
    its block of the slots (a :class:`CacheBlock`), attended as
    :class:`Attention` attends one.
    """

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        if cfg.attn_kind != "mla":
            raise ValueError(f"attn_kind={cfg.attn_kind!r} is not MLA")
        self.cfg = cfg
        d, H, rank = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            self.wq_a = Dense(d, cfg.q_lora_rank, init)
            self.q_norm_scale = init.full((cfg.q_lora_rank,), 1.0)
            self.wq_b = Dense(cfg.q_lora_rank, H * (dn + dr), init)
        else:
            self.wq_a = self.q_norm_scale = None
            self.wq_b = Dense(d, H * (dn + dr), init)
        self.wkv_a = Dense(d, rank + dr, init)
        self.kv_norm_scale = init.full((rank,), 1.0)
        self.wk_b = Dense(rank, H * dn, init)
        self.wv_b = Dense(rank, H * cfg.v_head_dim, init)
        self.wo = Dense(H * cfg.v_head_dim, d, init)
        self.tp: Optional[TensorParallel] = None
        self.slots: Optional[TensorParallel] = None

    def forward(self, x, positions, cache: Optional[dict] = None,
                cache_index: int = 0, window: int = 0, q_chunk: int = 512,
                kv_chunk: int = 512, skip_masked_blocks: bool = False):
        """x: (B, S, d); positions (B, S), or (B, S, 3) under mrope.
        ``window`` is accepted for the block's uniform call and ignored, as
        the reference ignores it for MLA (its cache is no ring)."""
        cfg, tp = self.cfg, self.tp
        B, S, _ = x.shape
        H, rank = cfg.num_heads, cfg.kv_lora_rank
        if tp is not None:  # this rank's heads
            H //= tp.size
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        pos_1d = positions[..., 0] if positions.dim() == 3 else positions
        # the latents are whole; each enters the rank's heads alone (under
        # sequence parallelism as partial gradients, the latent weights'
        # summed over 'model' with the other whole parameters)
        if self.wq_a is not None:
            q = self.wq_b(enter_tp(rms_norm(
                self.wq_a(x), self.q_norm_scale, cfg.norm_eps), tp))
        else:
            q = self.wq_b(enter_tp(x, tp))
        q = q.reshape(B, S, H, dn + dr)
        q_nope, q_rope = q[..., :dn], _rope(cfg, q[..., dn:], positions)
        kv = self.wkv_a(x)
        ckv = enter_tp(rms_norm(kv[..., :rank], self.kv_norm_scale,
                                cfg.norm_eps), tp)
        krope = enter_tp(_rope(cfg, kv[..., None, rank:],
                               positions)[:, :, 0], tp)
        wk_b = self.wk_b.w.reshape(rank, H, dn)
        wv_b = self.wv_b.w.reshape(rank, H, dv)
        args = dict(causal=cfg.causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                    scale=1.0 / math.sqrt(dn + dr))
        if cache is None:
            k_nope = torch.einsum("bsr,rhd->bshd", ckv, wk_b)
            v = torch.einsum("bsr,rhd->bshd", ckv, wv_b)
            k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, dr)],
                          dim=-1)
            out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                  pos_1d, pos_1d,
                                  skip_masked_blocks=skip_masked_blocks,
                                  **args)
        else:
            q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)
            q_eff = torch.cat([q_abs, q_rope], dim=-1)  # (B, S, H, rank+dr)
            block = isinstance(cache, CacheBlock)
            if block and cache_index == 0:  # the prompt's entries, rounded
                ckv_c = ckv.to(cache["ckv"].dtype)
                kv_eff = torch.cat([ckv_c, krope.to(cache["krope"].dtype)],
                                   dim=-1)
                ctx = flash_attention(q_eff, kv_eff[:, :, None, :],
                                      ckv_c[:, :, None, :], pos_1d, pos_1d,
                                      **args)
            _cache_write(cache, ("ckv", "krope"), (ckv, krope), pos_1d,
                         cache_index, ring=False)
            if not (block and cache_index == 0):
                kv_eff = torch.cat([cache["ckv"], cache["krope"]], dim=-1)
                kv = (kv_eff[:, :, None, :], cache["ckv"][:, :, None, :])
                ctx = (_attend_slots(q_eff, *kv, pos_1d, cache, self.slots,
                                     tp is not None, **args) if block
                       else flash_attention(q_eff, *kv, pos_1d, cache["pos"],
                                            kv_valid=cache["pos"] >= 0,
                                            **args))  # (B, S, H, rank)
            out = torch.einsum("bshr,rhd->bshd", ctx, wv_b)
        return self.wo(out.reshape(B, S, H * dv), tp)
