"""The language model (counterpart of ``repro.models.model``): embeddings
(tokens, or the audio / VLM frontend stubs' precomputed embeddings), the
block stack, the final norm and the LM head (tied: ``h @ embedᵀ``).

:class:`LanguageModel` is built on a device (``cuda`` unless the caller
asks for another) from an explicit ``torch.Generator``; weights carried
from the reference load through ``load_state_dict`` (see
:func:`repro_torch.interop.lm_params_from_reference`). :func:`forward`
returns ``(logits, cache)``, with ``with_aux=True`` the reference's
``(logits, cache, aux)`` (the MoE layers' summed auxiliary loss): a cache
from :func:`init_cache` (one dict per layer) is updated in place and
returned. ``remat=True`` recomputes each block in the backward pass
(the reference's ``jax.checkpoint`` per block): training runs without a
cache. Placed with a 'model' group ``tp`` where the vocab divides it
(:func:`~repro_torch.distributed.sharding.distribute_model`), the
embedding and the head hold the rank's vocab rows: the lookup is summed
over the group and the head's logits are gathered along V
(``gather_logits=False``: the rank's columns, for the vocab-parallel
loss). Placed on a 'model' group ``sp`` of more than one rank, a forward
whose length divides it runs sequence-parallel
(:mod:`repro_torch.distributed.tensor_parallel`): the embedding gives the
rank's positions (a split lookup reduce-scattered, an unsplit one looked
up whole and cut to them), the blocks carry them, and the final norm runs
on them; the head takes them gathered along S (a split vocab's partial
gradients reduce-scattered back, an unsplit one computed alike by every
rank on every position, its gradient narrowed), and the prefill's last
position comes from the rank that holds it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.actsharding import recompute_contexts
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     copy_to_tp,
                                                     gather_from_sp,
                                                     gather_from_tp,
                                                     scatter_to_sp,
                                                     sequence_parallel,
                                                     sp_group, sp_shard,
                                                     sum_over_tp)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES, Init, Norm
from repro_torch.models.transformer import (Block, StackLayout,
                                            check_ported, init_layer_cache)

__all__ = ["LanguageModel", "forward", "init_cache", "default_positions",
           "embed_inputs", "sequence_length"]


class LanguageModel(nn.Module):
    """Weights of ``cfg`` at its ``param_dtype`` on ``device``.

    ``generator`` (on ``device``; default: seeded 0) supplies every draw,
    with the reference's distributions. ``device="meta"`` allocates the
    parameters without values (shapes only). Raises ``ValueError`` for a
    config with an unknown layer kind."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device, None] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_ported(cfg)
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        init = Init(dev, DTYPES[cfg.param_dtype], generator)
        self.cfg = cfg
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), 0.02)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, init, use_moe=StackLayout.moe_of(cfg, i))
            for i, kind in enumerate(cfg.layer_kinds))
        self.final_norm = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, init)
        self.lm_head = (init.normal((cfg.d_model, cfg.vocab_size),
                                    cfg.d_model ** -0.5)
                        if cfg.has_lm_head and not cfg.tie_embeddings
                        else None)
        self.tp: Optional[TensorParallel] = None  # the vocab's
        self.sp: Optional[TensorParallel] = None  # the sequence's

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def sequence_parallel_group(self, batch: dict
                                ) -> Optional[TensorParallel]:
        """The 'model' group over which a forward of ``batch`` runs
        sequence-parallel (a placed model's, where the length divides it;
        the reference's ``_axis_ok`` guard), else ``None``."""
        sp = self.sp
        if sp is None or sequence_length(self.cfg, batch) % sp.size:
            return None
        return sp

    def forward(self, batch: dict, cache: Optional[list] = None,
                cache_index: int = 0, positions=None,
                attn_args: Optional[dict] = None, last_only: bool = False,
                with_aux: bool = False, remat: bool = False,
                gather_logits: bool = True):
        """Returns (logits (B, S, V), cache), with ``with_aux`` also the
        MoE layers' summed auxiliary loss (an f32 scalar; 0 without MoE).
        ``batch`` holds ``tokens`` (B, S) and optionally ``features``,
        ``vision_embeds`` / ``vision_mask`` and ``positions``;
        ``cache_index`` is the slot of the first new token (a Python int).
        ``last_only`` projects only the last position through the head
        (the prefill path). ``remat`` keeps only each block's input for
        backward and recomputes the block there (no cache allowed).
        ``gather_logits=False`` (placed training's loss): a split vocab's
        logits as the rank computed them, its vocab columns."""
        sp = self.sequence_parallel_group(batch)
        with sequence_parallel(sp):
            return self._forward(batch, cache, cache_index, positions,
                                 attn_args, last_only, with_aux, remat,
                                 gather_logits)

    def _forward(self, batch, cache, cache_index, positions, attn_args,
                 last_only, with_aux, remat, gather_logits):
        cfg, sp = self.cfg, sp_group()
        h = embed_inputs(self, batch)
        B, S = h.shape[0], sequence_length(cfg, batch)
        if positions is None:
            positions = batch.get("positions")
        if positions is None:
            positions = default_positions(cfg, B, S, cache_index,
                                          device=self.device)
        positions = positions.to(self.device)
        attn_args = attn_args or {}
        if remat and cache is not None:
            raise ValueError("remat recomputes blocks for backward: training "
                             "takes no cache")
        remat = remat and torch.is_grad_enabled()
        aux = None
        for i, block in enumerate(self.blocks):
            if remat:
                h, a = checkpoint(block, h, positions, None, cache_index,
                                  attn_args, use_reentrant=False,
                                  context_fn=recompute_contexts)
            else:
                h, a = block(h, positions,
                             cache[i] if cache is not None else None,
                             cache_index, attn_args)
            if a is not None:
                aux = a if aux is None else aux + a
        if last_only:  # under SP the last rank's last position
            h = h[:, -1:, :]
            if sp is not None:
                h = gather_from_tp(h, sp, dim=1)[:, -1:, :]
                sp = None
        h = self.final_norm(h)
        split_head = cfg.has_lm_head and self.tp is not None
        if sp is not None:  # every position: a split head's partial
            # gradients summed back to the positions, else each rank's
            # gradient of the same loss narrowed to them
            h = (gather_from_sp(h, sp) if split_head
                 else gather_from_tp(h, sp, dim=1))
        elif split_head:
            h = copy_to_tp(h, self.tp)
        if not cfg.has_lm_head:
            out = h
        else:
            if cfg.tie_embeddings:
                out = torch.einsum("bsd,vd->bsv", h, self.embed)
            else:
                out = h @ self.lm_head
            if gather_logits:
                out = gather_from_tp(out, self.tp)
        if not with_aux:
            return out, cache
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return out, cache, aux


def forward(model: LanguageModel, batch: dict, cache: Optional[list] = None,
            cache_index: int = 0, **kwargs):
    """``model(batch, cache, cache_index, ...)``: the reference's
    ``forward`` with the weights in the module."""
    return model(batch, cache, cache_index, **kwargs)


def sequence_length(cfg: ModelConfig, batch: dict) -> int:
    """The length of the sequences in ``batch`` (its features' under the
    audio frontend stub, else its tokens')."""
    if cfg.frontend_stub and "features" in batch:
        return batch["features"].shape[1]
    return batch["tokens"].shape[1]


def embed_inputs(model: LanguageModel, batch: dict) -> torch.Tensor:
    """Token embedding at the activation dtype, with the frontend stubs:
    ``features`` (B, S, d) replace the tokens (audio), ``vision_embeds``
    (B, S, d) replace them where ``vision_mask`` (B, S) is set (VLM).
    In a sequence-parallel forward: the rank's positions."""
    cfg = model.cfg
    dtype = DTYPES[cfg.dtype]
    dev = model.device
    sp = sp_group()
    if cfg.frontend_stub and "features" in batch:
        h = scatter_to_sp(batch["features"].to(device=dev, dtype=dtype), sp)
    else:
        # F.embedding: its backward sums each row's gradients in a fixed
        # order (an index's accumulating scatter does not on the CPU)
        tokens, tp = batch["tokens"].to(dev), model.tp
        if tp is None:  # under SP looked up whole, cut to the positions
            h = scatter_to_sp(F.embedding(tokens, model.embed).to(dtype), sp)
        else:  # the rank's vocab rows, zero elsewhere, summed over 'model'
            lo = tp.rank * model.embed.shape[0]
            mine = (tokens >= lo) & (tokens < lo + model.embed.shape[0])
            h = F.embedding(torch.where(mine, tokens - lo, 0), model.embed)
            h = sum_over_tp(torch.where(mine[..., None], h, 0).to(dtype), tp)
    if "vision_embeds" in batch:
        mask = sp_shard(batch["vision_mask"].to(dev), sp)[..., None]
        h = torch.where(mask, scatter_to_sp(batch["vision_embeds"].to(
            device=dev, dtype=dtype), sp), h)
    return h


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device, None] = None,
               tp: int = 1, rank: int = 0) -> list:
    """One cache dict per layer, at ``cfg.cache_dtype`` (default: the
    activation dtype): K/V and slot positions for attention (a ring buffer
    of the window under local attention), ``(h, conv)`` for RG-LRU,
    ``(S, shift_tm, shift_cm)`` for RWKV-6. A float8 cache rounds on write
    and reads back at f32. MLA layers keep the compressed ``ckv`` and
    ``krope`` (no ring). ``tp``, ``rank``: the cache of the rank at
    ``rank`` of a placed model on a 'model' axis of ``tp`` ranks, whose
    split attention holds only the rank's KV heads, whose attention layers
    hold the rank's block of the slots where their slot group has more
    than one rank
    (:func:`~repro_torch.distributed.tensor_parallel.slot_block`; a
    ``CacheBlock``), a split RG-LRU the rank's channels of ``h`` and
    ``conv`` and a split RWKV-6 the rank's heads of ``S``."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.cache_dtype or cfg.dtype]
    return [init_layer_cache(cfg, kind, batch, max_len, dtype, dev, tp, rank)
            for kind in cfg.layer_kinds]


def default_positions(cfg: ModelConfig, batch: int, seq: int,
                      offset: int = 0, device=None) -> torch.Tensor:
    """(B, S) int32 positions ``offset, offset+1, ...``; (B, S, 3) under
    mrope (text tokens: t == h == w)."""
    pos = torch.arange(offset, offset + seq, dtype=torch.int32,
                       device=device)[None, :].expand(batch, seq)
    if cfg.pos_emb == "mrope":
        pos = pos[..., None].expand(batch, seq, 3)
    return pos
