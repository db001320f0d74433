"""Tensor parallelism over a placed model's 'model' axis: which blocks
split, and the autograd collectives of the 'model' group (Megatron's
pattern, in c10d calls).

The reference's rules put heads, FFN hidden and vocab on 'model'
(:mod:`repro_torch.distributed.sharding`), and its GSPMD computes each
head and each FFN slice on the rank that holds it. A placed model of the
port does the same where a block's shapes allow (:func:`split_plan`):

* attention (GQA / MHA): ``wq``, ``wk``, ``wv`` column-parallel (the
  rank's ``H/tp`` contiguous query heads and the KV heads they use), ``wo``
  row-parallel and followed by one all-reduce. It splits where
  ``num_heads % tp == 0`` and either ``num_kv_heads % tp == 0`` or
  ``tp % num_kv_heads == 0``. In the second case each KV head is
  replicated on the ``tp / num_kv_heads`` ranks whose query heads use it:
  they take ``wk`` and ``wv`` whole and slice their head out, and the
  whole tensors' gradients are summed over 'model' before they are cut.
* a dense MLP (all four kinds): ``wi``, ``wg`` column-parallel, ``wo``
  row-parallel and followed by one all-reduce, where ``d_ff % tp == 0``.
* the vocab, where ``vocab_size % tp == 0``: the embedding looks up the
  rank's rows (zero elsewhere) and all-reduces; the head (tied or not)
  computes the rank's vocab columns and all-gathers them along V.

A bias of a row-parallel projection is added once, after the sum. MLA,
RG-LRU, RWKV-6 and the MoE router and experts stay whole: their weights are
gathered whole along 'model' and every 'model' rank computes all of them.
Block boundaries are replicated along 'model'.

The collectives call ``torch.distributed`` through the module attribute
when they run, so that
:func:`~repro_torch.launch.roofline.record_collectives` counts them; they
use no DTensor functional collectives (see ``sharding._all_gather``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["TensorParallel", "SplitPlan", "attention_splits", "mlp_splits",
           "vocab_splits", "split_plan", "local_kv_heads", "copy_to_tp",
           "reduce_from_tp", "gather_from_tp"]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A module's 'model' group: the c10d process group, its size and this
    rank's index in it."""

    group: object
    size: int
    rank: int


# ----------------------------------------------------------- the rule ----
def attention_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s GQA / MHA attention splits over ``tp`` ranks."""
    if tp <= 1 or cfg.attn_kind != "gqa":
        return False
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return H % tp == 0 and (Hkv % tp == 0 or tp % Hkv == 0)


def mlp_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s dense MLPs split over ``tp`` ranks."""
    return tp > 1 and cfg.d_ff % tp == 0


def vocab_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s embedding and head split over ``tp`` ranks."""
    return tp > 1 and cfg.vocab_size % tp == 0


def local_kv_heads(cfg, tp: int) -> int:
    """The KV heads a rank of a ``tp``-wide 'model' axis holds: all of them
    where the attention stays whole, else ``num_kv_heads / tp`` or the one
    replicated head."""
    if not attention_splits(cfg, tp):
        return cfg.num_kv_heads
    return max(cfg.num_kv_heads // tp, 1)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Which parts of a model compute tensor-parallel on a 'model' axis:
    the layers whose attention splits, those whose dense MLP splits, and
    the vocab."""

    attention: tuple
    mlp: tuple
    vocab: bool
    kv_replicated: bool  # the split attention's KV heads: tp > num_kv_heads

    def mode(self, name: str) -> str:
        """How a placed model uses the parameter ``name`` (its state-dict
        name): ``"shard"`` (its 'model' shard, gathered over the
        data-parallel axes only), ``"head"`` (gathered whole, the rank's KV
        head sliced out) or ``"whole"`` (gathered whole)."""
        if name in ("embed", "lm_head"):
            return "shard" if self.vocab else "whole"
        parts = name.split(".")
        if parts[0] != "blocks":
            return "whole"
        layer, sub = int(parts[1]), parts[2]
        if sub == "inner" and layer in self.attention:
            return "head" if (self.kv_replicated
                              and parts[3] in ("wk", "wv")) else "shard"
        if sub == "mlp" and layer in self.mlp:
            return "shard"
        return "whole"


def split_plan(cfg, tp: int) -> SplitPlan:
    """The :class:`SplitPlan` of ``cfg`` on a 'model' axis of ``tp`` ranks
    (a pure function of the config: nothing splits at ``tp`` 1)."""
    moe_from = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
    attn, mlp = attention_splits(cfg, tp), mlp_splits(cfg, tp)
    kinds = cfg.layer_kinds
    return SplitPlan(
        attention=tuple(i for i, k in enumerate(kinds)
                        if attn and k == "attn"),
        mlp=tuple(i for i, k in enumerate(kinds)
                  if mlp and k != "rwkv6" and i < moe_from),
        vocab=vocab_splits(cfg, tp),
        kv_replicated=attn and tp > cfg.num_kv_heads)


# ------------------------------------------------ autograd collectives ----
def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` summed over the 'model' group, into a fresh tensor (c10d's
    all-reduce works in place)."""
    import torch.distributed as dist

    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=tp.group)
    return x


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over 'model' in backward (the
    input of a column-parallel part, each rank differentiating its own
    columns)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial results summed over 'model' forward (a row-parallel
    product, the vocab-parallel lookup); the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The ranks' slices all-gathered along ``dim`` forward, the rank's
    slice of the gradient in backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        import torch.distributed as dist

        ctx.tp, ctx.dim, ctx.width = tp, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g.narrow(ctx.dim, ctx.tp.rank * w, w).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """``x`` into a tensor-parallel part (``x`` itself without ``tp``)."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """``x`` summed over the 'model' group (``x`` itself without ``tp``)."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: Optional[TensorParallel],
                   dim: int = -1):
    """The 'model' ranks' ``x`` concatenated along ``dim`` (``x`` itself
    without ``tp``)."""
    return x if tp is None else _GatherFromTP.apply(x, tp, dim % x.dim())
