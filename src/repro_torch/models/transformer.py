"""Block and stack of the LM path (counterpart of
``repro.models.transformer``): one pre-norm residual block per layer kind
(attn / rwkv6 / rglru; attn is GQA or MLA), its MLP dense or a MoE layer,
run as a Python loop over an ``nn.ModuleList``.

The reference stacks the layers of each pattern slot for ``lax.scan``
(prologue / scanned cycles / epilogue, :class:`StackLayout`); here the
blocks are one list in layer order, and :meth:`StackLayout.layer` maps the
reference's ``body[j]`` entry of cycle ``c`` to its layer. A layer is MoE
when the config has experts and the layer is past ``first_dense_layers``
(:meth:`StackLayout.moe_of`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from torch import nn

from repro_torch.distributed.tensor_parallel import (gather_from_sp,
                                                     sp_group, sp_shard)
from repro_torch.models.attention import (Attention, MLAttention,
                                          init_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Init, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU, init_rglru_state
from repro_torch.models.rwkv6 import RWKV6, init_rwkv_state

__all__ = ["StackLayout", "Block", "check_ported", "init_layer_cache"]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config with a layer kind the stack does
    not know."""
    unknown = set(cfg.layer_kinds) - {"attn", "rwkv6", "rglru"}
    if unknown:
        raise ValueError(f"unknown layer kinds {sorted(unknown)}")


@dataclasses.dataclass(frozen=True)
class StackLayout:
    """How num_layers decomposes into prologue / scanned cycles / epilogue
    in the reference's params and caches."""

    pattern: Tuple[str, ...]
    prologue: Tuple[int, ...]  # absolute layer indices
    cycles: int
    epilogue: Tuple[int, ...]

    @classmethod
    def build(cls, cfg: ModelConfig) -> "StackLayout":
        P = len(cfg.layer_pattern)
        pro = tuple(range(cfg.first_dense_layers))
        cycles = (cfg.num_layers - len(pro)) // P
        epi_start = len(pro) + cycles * P
        return cls(pattern=cfg.layer_pattern, prologue=pro, cycles=cycles,
                   epilogue=tuple(range(epi_start, cfg.num_layers)))

    def layer(self, j: int, c: int) -> int:
        """The layer of the reference's ``body[j]``, cycle ``c``."""
        return len(self.prologue) + c * len(self.pattern) + j

    @staticmethod
    def moe_of(cfg: ModelConfig, layer: int) -> bool:
        """Whether ``layer``'s MLP is a MoE layer (deepseek-v2's first
        layer keeps its dense MLP)."""
        return cfg.is_moe and layer >= cfg.first_dense_layers


class Block(nn.Module):
    """Pre-norm residual block: ``x + inner(norm1(x))``, then
    ``x + mlp(norm2(x))`` (an RWKV-6 layer's own channel mix in place of
    the MLP; with ``use_moe`` a :class:`~repro_torch.models.moe.MoE`).

    In a sequence-parallel forward
    (:func:`~repro_torch.distributed.tensor_parallel.sequence_parallel`)
    ``x`` is the rank's ``(rows, S/tp, d)`` positions: the norms and the
    residual adds run on them, each normed input is all-gathered along S
    for its part, a split part reduce-scatters its sum back to the
    positions, and a part that stays whole keeps its output's rank
    positions."""

    def __init__(self, cfg: ModelConfig, kind: str, init: Init,
                 use_moe: bool = False):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, init)
        attn = MLAttention if cfg.attn_kind == "mla" else Attention
        self.inner = {"attn": attn, "rwkv6": RWKV6,
                      "rglru": RGLRU}[kind](cfg, init)
        self.norm2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, init)
        if kind == "rwkv6":
            self.mlp = None
        elif use_moe:
            self.mlp = MoE(cfg, init)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, init,
                           cfg.mlp_bias)

    def forward(self, x, positions, cache: Optional[dict], cache_index: int,
                attn_args: dict):
        """Returns ``(x, aux)``: the MoE layer's auxiliary loss, ``None``
        without one."""
        sp = sp_group()
        h = gather_from_sp(self.norm1(x), sp)
        if self.kind == "attn":
            y = self.inner(h, positions, cache, cache_index,
                           window=self.cfg.local_window, **attn_args)
        else:
            y = self.inner(h, cache)
        x = x + self._positions(y, self.inner, sp)
        h = gather_from_sp(self.norm2(x), sp)
        aux = None
        if self.kind == "rwkv6":
            y, part = self.inner.channel_mix(h, cache), self.inner
        elif isinstance(self.mlp, MoE):
            (y, aux), part = self.mlp(h), self.mlp
        else:
            y, part = self.mlp(h), self.mlp
        return x + self._positions(y, part, sp), aux

    @staticmethod
    def _positions(y, part, sp):
        """A part's output on the residual stream's positions: a split
        part's (its ``tp`` set) reduce-scattered them itself."""
        return y if part.tp is not None else sp_shard(y, sp)


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, tp: int = 1, rank: int = 0) -> dict:
    """One layer's serving cache; ``tp``, ``rank``: that of the rank at
    ``rank`` of a 'model' axis of ``tp`` ranks (an attention layer's KV
    heads and its block of the slots)."""
    if kind == "attn":
        return init_kv_cache(cfg, batch, max_len, dtype, device,
                             window=cfg.local_window, tp=tp, rank=rank)
    # the recurrent states hold the rank's heads / channels where the
    # block splits over 'model' (the placed serving cache); the dry-run's
    # residency (sharding.cache_shardings) keeps the reference's rule,
    # which leaves ``conv`` whole on 'model' (its axis 1 is cw - 1)
    if kind == "rwkv6":
        return init_rwkv_state(cfg, batch, dtype, device, tp)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, dtype, device, tp)
    raise ValueError(kind)
