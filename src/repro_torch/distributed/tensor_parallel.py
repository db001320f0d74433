"""Tensor parallelism over a placed model's 'model' axis: which blocks
split, and the autograd collectives of the 'model' group (Megatron's
pattern, in c10d calls).

The reference's rules put heads, FFN hidden, experts and vocab on 'model'
(:mod:`repro_torch.distributed.sharding`), and its GSPMD computes each
head, FFN slice and expert on the rank that holds it. A placed model of
the port does the same where a block's shapes allow (:func:`split_plan`):

* attention (GQA / MHA): ``wq``, ``wk``, ``wv`` column-parallel (the
  rank's ``H/tp`` contiguous query heads and the KV heads they use), ``wo``
  row-parallel and followed by one all-reduce. It splits where
  ``num_heads % tp == 0`` and either ``num_kv_heads % tp == 0`` or
  ``tp % num_kv_heads == 0``. In the second case each KV head is
  replicated on the ``tp / num_kv_heads`` ranks whose query heads use it:
  they take ``wk`` and ``wv`` whole and slice their head out, and the
  whole tensors' gradients are summed over 'model' before they are cut.
* MLA, where ``num_heads % tp == 0``: ``wq_b``, ``wk_b``, ``wv_b``
  column-parallel by heads, ``wo`` row-parallel and followed by one
  all-reduce. The latent projections ``wq_a`` and ``wkv_a`` and their
  norms stay whole, computed alike on every rank; their outputs (the
  query latent, ``ckv``, ``krope``) enter the rank's heads through
  :func:`copy_to_tp`, so their gradients are summed over 'model' there.
  The compressed cache is every head's: its slots split (below).
* a dense MLP (all four kinds): ``wi``, ``wg`` column-parallel, ``wo``
  row-parallel and followed by one all-reduce, where ``d_ff % tp == 0``.
* a MoE layer, by the reference's rule: by experts where ``num_experts %
  tp == 0`` (expert parallelism: the rank computes its ``E/tp``
  contiguous experts on the slots routing gave them), else by each
  expert's ff columns where ``e_ff % tp == 0`` (``wi``, ``wg``
  column-parallel, ``wo`` row-parallel), else whole. The shared expert
  splits column / row where its width divides. The router, top-k,
  capacity and the aux loss are computed alike on every rank, and one
  all-reduce sums the rank's partial combine and shared output. No token
  moves between ranks: every rank holds all the tokens of its batch rows
  (the block input replicated along 'model', or gathered under sequence
  parallelism). The all-to-all form of expert parallelism is not ported.
* the vocab, where ``vocab_size % tp == 0``: the embedding looks up the
  rank's rows (zero elsewhere) and all-reduces (reduce-scatters under
  SP); the head (tied or not) computes the rank's vocab columns and
  all-gathers them along V, but not in training, whose vocab-parallel
  cross-entropy (``train.train_step.loss_fn``) takes the rank's columns.
* RG-LRU, where ``lru_width % tp == 0``, by width: ``w_in`` and
  ``w_gate_in`` column-parallel (the rank's ``w/tp`` contiguous
  channels), the causal conv, the decay, the drive, the scan and the gate
  on those channels, ``w_out`` row-parallel and followed by one
  all-reduce. ``wa`` and ``wx`` are full ``(w, w)`` matrices: the conv's
  output ``u`` is all-gathered along the width, and the rank computes its
  columns of both gates from the whole of it; the gathered ``u``'s
  gradient is summed over 'model' before the rank's slice is cut.
* RWKV-6, where its heads (``d_model / rwkv_head_dim``) and ``d_ff``
  divide ``tp``, by heads: ``wr``, ``wk``, ``wv``, ``wg`` column-parallel
  (the rank's ``H/tp`` contiguous heads and their channels), the WKV
  recurrence on those heads with the rank's state, ``wo`` row-parallel
  and followed by one all-reduce; the channel mix's ``cm_k``
  column-parallel and ``cm_v`` row-parallel, and ``cm_r``, whose 'model'
  shard is its input rows, row-parallel on the rank's slice of its input:
  two all-reduces, before the sigmoid gate meets the value.

The per-channel parameters of those two blocks that the reference keeps
whole (RG-LRU's ``conv_w``, ``conv_b``, ``lam``; RWKV-6's ``w0``, ``u``,
``w_lora_b``) are gathered whole and narrowed to the rank's channels
along their last dimension (:meth:`SplitPlan.mode` ``"channels"``);
RWKV-6's token-shift mixes and ``w_lora_a``, which every rank uses alike
inside the split block, are gathered whole (``"summed"``). Both enter
through :func:`copy_to_tp`, so their gradients, each rank's taken through
its own channels only, are summed over 'model', as a replicated KV head's
``wk`` and ``wv`` are (``"head"``).

A bias of a row-parallel projection is added once, after the sum. What
does not divide stays whole: its weights are gathered whole along 'model'
and every 'model' rank computes it.

The serving cache along its slots (the reference's ``cache_shardings``:
a KV cache's slot axis on 'model', flash-decoding). The **slot group** of
an attention layer is the set of 'model' ranks that compute the same
cache entries; its size ``g`` (:func:`slot_group_size`) is ``tp`` for
MLA, whose ``ckv`` and ``krope`` every rank computes whole, ``tp`` for a
GQA / MHA attention that does not split, ``tp / num_kv_heads`` where the
split attention replicates its KV heads (consecutive ranks, since a
rank's query heads are contiguous), and 1 otherwise. A rank holds its KV
heads and the contiguous block ``[j·size/g, (j+1)·size/g)`` of the slots
(:func:`slot_block`), ``j`` its index in the group: ``_fit``'s
contiguous split of axis 1. Where ``size % g != 0`` the layer's cache
stays whole on the group, as ``_fit`` replicates a dimension that does
not divide. A ring cache follows the same rule (a slot is still ``index
mod size``, written by its owner alone). Where the queries attend the
cache (decode, a prefill at ``cache_index > 0``), each rank attends its
own slots and the group merges the partial softmaxes
(:func:`combine_over_slots`): where the group's ranks hold other query
heads, they all-gather their queries along heads first
(:func:`gather_heads`), all-reduce the partial maxima and reduce-scatter
the rescaled numerators and denominators back to each rank's heads;
where every rank holds every head (the attention whole), both are
all-reduces. The messages are the size of the queries and of the
output, never the size of the cache. A prefill into a fresh cache
(``cache_index`` 0) needs none: every rank of the group holds the
prompt's entries (the input is replicated, or gathered along S), so it
attends them in context and writes its own slots.

Sequence parallelism (Megatron-SP, the reference's ``"sp"``: its blocks
constrain their input to ``("dp", "sp", None)``). Inside a placed model
whose 'model' group has more than one rank, a forward whose length S
divides the group (training and prefill; not decode at S = 1, nor an odd
prompt, which run the path above) holds the residual stream between
blocks as the rank's ``S/tp`` contiguous positions
(:func:`sequence_parallel`, set by the model's forward). What SP shards:
the residual stream and its adds, the block norms, the final norm and
the embedding's output. What it does not: inside a block the sequence is
whole, and the head takes every position (the final norm's output
all-gathered: :func:`gather_from_sp` into a split vocab's columns, else
:func:`gather_from_tp`, every rank projecting every position and its
gradient narrowed to the positions). Each block part
all-gathers its normed input along S (:func:`gather_from_sp`, whose
backward reduce-scatters the partial input gradients, so the part takes
its input without :func:`copy_to_tp`: :func:`enter_tp`); a split part's
row-parallel sum is a reduce-scatter to the rank's positions
(:func:`sum_over_tp`, :func:`reduce_scatter_to_sp`), where it is an
all-reduce without SP; a part that stays whole computes on the gathered
input and keeps its output's rank positions (:func:`sp_shard`). Chunked
attention, the caches, the RG-LRU conv and scan, the RWKV-6 token shifts
and WKV chunks and the MoE dispatch see every position. Each rank then
differentiates the parameters it uses whole (the norm scales, a whole
part's weights, MLA's latent projections, the router) and a row-parallel
projection's bias (added after the reduce-scatter)
through its own positions only, so under SP their gradients are summed
over 'model' as the ``"summed"`` ones are
(:func:`~repro_torch.distributed.sharding.distribute_model`).
:func:`scatter_to_sp` cuts a replicated input (an unsplit vocab's
lookup, made whole on every rank, and the frontend stubs' embeddings) to
the rank's positions; its backward all-gathers the gradient, so that each
rank holds an unsplit embedding's whole gradient and nothing sums it.

The collectives call ``torch.distributed`` through the module attribute
when they run, so that
:func:`~repro_torch.launch.roofline.record_collectives` counts them; they
use no DTensor functional collectives (see ``sharding._all_gather``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

__all__ = ["TensorParallel", "SplitPlan", "attention_splits", "mla_splits",
           "mlp_splits", "moe_splits", "shared_expert_splits", "vocab_splits",
           "rglru_splits", "rwkv_splits", "split_plan", "local_kv_heads",
           "copy_to_tp", "reduce_from_tp", "gather_from_tp",
           "sequence_parallel", "sp_group", "scatter_to_sp",
           "gather_from_sp", "reduce_scatter_to_sp", "sum_over_tp",
           "enter_tp", "sp_shard", "slot_group_size", "slot_block",
           "gather_heads", "combine_over_slots", "merge_slot_partials"]

# the 'model' group of the innermost sequence-parallel forward, None
# outside one
_SP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sequence_parallel", default=None)


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


def mla_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s MLA splits by heads over ``tp`` ranks."""
    return tp > 1 and cfg.attn_kind == "mla" and cfg.num_heads % tp == 0


def mlp_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s dense MLPs split over ``tp`` ranks."""
    return tp > 1 and cfg.d_ff % tp == 0


def moe_splits(cfg, tp: int) -> Optional[str]:
    """How ``cfg``'s MoE layers split over ``tp`` ranks: ``"expert"``
    (expert parallelism) where the experts divide ``tp``, else ``"ff"``
    (each expert's ff columns) where their width does, else ``None``
    (whole): the reference's rule for the expert stacks."""
    if tp <= 1 or not cfg.is_moe:
        return None
    if cfg.num_experts % tp == 0:
        return "expert"
    return "ff" if (cfg.moe_d_ff or cfg.d_ff) % tp == 0 else None


def shared_expert_splits(cfg, tp: int) -> bool:
    """Whether a split MoE layer's shared expert (width ``e_ff ·
    num_shared_experts``) splits over ``tp`` ranks too."""
    width = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
    return (moe_splits(cfg, tp) is not None and width > 0
            and width % tp == 0)


def vocab_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s embedding and head split over ``tp`` ranks."""
    return tp > 1 and cfg.vocab_size % tp == 0


def rglru_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s RG-LRU blocks split by width over ``tp`` ranks
    (the spec cuts ``w_in``, ``w_gate_in``, ``wa``, ``wx`` and ``w_out``
    along ``lru_width`` exactly then)."""
    return tp > 1 and "rglru" in cfg.layer_kinds and cfg.lru_width % tp == 0


def rwkv_splits(cfg, tp: int) -> bool:
    """Whether ``cfg``'s RWKV-6 blocks split by heads over ``tp`` ranks:
    the heads and the channel mix's ``d_ff`` both divide."""
    if tp <= 1 or "rwkv6" not in cfg.layer_kinds:
        return False
    return (cfg.d_model // cfg.rwkv_head_dim) % tp == 0 and cfg.d_ff % tp == 0


def local_kv_heads(cfg, tp: int) -> int:
    """The KV heads a rank of a ``tp``-wide 'model' axis holds: all of them
    where the attention stays whole, else ``num_kv_heads / tp`` or the one
    replicated head."""
    if not attention_splits(cfg, tp):
        return cfg.num_kv_heads
    return max(cfg.num_kv_heads // tp, 1)


def slot_group_size(cfg, tp: int) -> int:
    """The size ``g`` of the slot group of ``cfg``'s attention layers on a
    'model' axis of ``tp`` ranks: the ranks that compute the same cache
    entries (``tp`` for MLA and for an attention that does not split,
    ``tp / num_kv_heads`` for replicated KV heads, else 1)."""
    if tp <= 1 or "attn" not in cfg.layer_kinds:
        return 1
    if cfg.attn_kind == "mla" or not attention_splits(cfg, tp):
        return tp
    return max(tp // cfg.num_kv_heads, 1)


def slot_block(size: int, g: int, rank: int) -> tuple:
    """``(first, n)``: the block ``[first, first + n)`` of a cache's
    ``size`` slots that the 'model' rank ``rank`` holds in its slot group
    of ``g`` consecutive ranks (its index there ``rank % g``); all of them
    where ``size`` does not divide ``g``."""
    if g <= 1 or size % g:
        return 0, size
    n = size // g
    return rank % g * n, n


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Which parts of a model compute tensor-parallel on a 'model' axis:
    the layers whose GQA / MHA attention splits, those whose dense MLP
    splits, the vocab, the layers whose MLA splits by heads, and the MoE
    layers that split with how (``(layer, "expert" | "ff")`` pairs) and
    whether their shared expert splits too; the attention layers whose
    slot group has more than one rank (``slots``) and its size
    (``slot_group``)."""

    attention: tuple
    mlp: tuple
    vocab: bool
    kv_replicated: bool  # the split attention's KV heads: tp > num_kv_heads
    mla: tuple = ()
    moe: tuple = ()
    moe_shared: bool = False
    rglru: tuple = ()
    rwkv: tuple = ()
    slots: tuple = ()
    slot_group: int = 1

    RGLRU_SHARD = ("w_in", "w_gate_in", "wa", "wx", "w_out")
    RGLRU_CHANNELS = ("conv_w", "conv_b", "lam")
    RWKV_SHARD = ("wr", "wk", "wv", "wg", "wo", "cm_k", "cm_v", "cm_r")
    RWKV_CHANNELS = ("w0", "u", "w_lora_b")
    RWKV_SUMMED = ("mix_r", "mix_k", "mix_v", "mix_w", "cm_mix", "w_lora_a")

    def mode(self, name: str) -> str:
        """How a placed model uses the parameter ``name`` (its state-dict
        name): ``"shard"`` (its 'model' shard, gathered over the
        data-parallel axes only), ``"head"`` (gathered whole, the rank's KV
        head sliced out), ``"channels"`` (gathered whole, the rank's
        channels of its last dimension sliced out), ``"summed"`` (gathered
        whole and used alike by every rank inside a split block) or
        ``"whole"`` (gathered whole). The gradients of the ``"head"``,
        ``"channels"`` and ``"summed"`` tensors are summed over 'model'."""
        if name in ("embed", "lm_head"):
            return "shard" if self.vocab else "whole"
        parts = name.split(".")
        if parts[0] != "blocks":
            return "whole"
        layer, sub = int(parts[1]), parts[2]
        if sub == "inner" and layer in self.attention:
            return "head" if (self.kv_replicated
                              and parts[3] in ("wk", "wv")) else "shard"
        if sub == "inner" and layer in self.mla:  # not the latent parts
            return ("shard" if parts[3] in ("wq_b", "wk_b", "wv_b", "wo")
                    else "whole")
        if sub == "mlp" and layer in self.mlp:
            return "shard"
        if sub == "mlp" and layer in dict(self.moe):  # not the router
            if parts[3] == "shared":
                return "shard" if self.moe_shared else "whole"
            return "shard" if parts[3] in ("wi", "wg", "wo") else "whole"
        if sub == "inner" and layer in self.rglru:
            return ("shard" if parts[3] in self.RGLRU_SHARD else
                    "channels" if parts[3] in self.RGLRU_CHANNELS else
                    "whole")
        if sub == "inner" and layer in self.rwkv:
            return ("shard" if parts[3] in self.RWKV_SHARD else
                    "channels" if parts[3] in self.RWKV_CHANNELS else
                    "summed" if parts[3] in self.RWKV_SUMMED else "whole")
        return "whole"


def split_plan(cfg, tp: int) -> SplitPlan:
    """The :class:`SplitPlan` of ``cfg`` on a 'model' axis of ``tp`` ranks
    (a pure function of the config: nothing splits at ``tp`` 1)."""
    moe_from = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
    attn, mlp = attention_splits(cfg, tp), mlp_splits(cfg, tp)
    mla, moe = mla_splits(cfg, tp), moe_splits(cfg, tp)
    rglru, rwkv = rglru_splits(cfg, tp), rwkv_splits(cfg, tp)
    kinds = cfg.layer_kinds
    g = slot_group_size(cfg, tp)
    return SplitPlan(
        attention=tuple(i for i, k in enumerate(kinds)
                        if attn and k == "attn"),
        mlp=tuple(i for i, k in enumerate(kinds)
                  if mlp and k != "rwkv6" and i < moe_from),
        vocab=vocab_splits(cfg, tp),
        kv_replicated=attn and tp > cfg.num_kv_heads,
        mla=tuple(i for i, k in enumerate(kinds) if mla and k == "attn"),
        moe=tuple((i, moe) for i, k in enumerate(kinds)
                  if moe and k != "rwkv6" and i >= moe_from),
        moe_shared=shared_expert_splits(cfg, tp),
        rglru=tuple(i for i, k in enumerate(kinds) if rglru and k == "rglru"),
        rwkv=tuple(i for i, k in enumerate(kinds) if rwkv and k == "rwkv6"),
        slots=tuple(i for i, k in enumerate(kinds) if g > 1 and k == "attn"),
        slot_group=g)


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


# ------------------------------------------- the flash-decoding combine ----
@torch.inference_mode()
def gather_heads(x: torch.Tensor, slots: TensorParallel) -> torch.Tensor:
    """The slot group's queries (B, S, H, D) concatenated along heads (dim
    2), in the group's rank order: one all-gather (serving only)."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(slots.size)]
    dist.all_gather(parts, x.contiguous(), group=slots.group)
    return torch.cat(parts, dim=2)


def _rescaled(acc, m, l, m_max) -> torch.Tensor:
    """A rank's f32 partial numerator (B, S, H, Dv) and sum (B, S, H)
    rescaled from its own max ``m`` to the group's ``m_max``, packed as
    (B, S, H, Dv + 1) f64. A block with no valid slot (``m`` at
    ``NEG_INF``) gets weight 0: ``exp(-1e30 - m_max)`` is 0, never NaN.
    f64, since the merge adds roundings that one process's softmax does
    not have: rescaled and summed at f32, recurrentgemma-2b's smoke decode
    on (1, 2) lay 1.050e-6 from one process's (relative, over the
    largest), at f64 9.802e-7, as with its cache whole on each rank
    (``tests/torch_placed_drift.py --arch recurrentgemma-2b``)."""
    w = torch.exp(m.double() - m_max.double())
    return torch.cat([acc.double() * w[..., None],
                      (l.double() * w)[..., None]], dim=-1)


def _divided(packed: torch.Tensor) -> torch.Tensor:
    """The attention output (f64) of a packed numerator and sum."""
    return packed[..., :-1] / torch.clamp_min(packed[..., -1:], 1e-30)


def merge_slot_partials(parts) -> torch.Tensor:
    """The attention output (f64) of the partial softmaxes ``parts`` (a
    list of ``(acc, m, l)`` from ``flash_attention(partial=True)``, one a
    slot block), with no process group: what :func:`combine_over_slots`
    computes over a group's ranks, in one process."""
    m_max = torch.stack([m for _, m, _ in parts]).amax(0)
    return _divided(sum(_rescaled(a, m, l, m_max) for a, m, l in parts))


@torch.inference_mode()
def combine_over_slots(acc, m, l, slots: TensorParallel,
                       scatter: bool) -> torch.Tensor:
    """The attention output (f64) of this rank's partial softmax over its
    slot block merged with the slot group's: the f32 maxima all-reduced
    (MAX), then the rescaled f64 numerators and sums summed,
    reduce-scattered along
    heads to the rank's own heads (``scatter``: the queries were gathered
    by :func:`gather_heads`) or all-reduced (every rank holds every
    head). Serving only: no backward."""
    import torch.distributed as dist

    m_max = m.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(m_max, op=dist.ReduceOp.MAX, group=slots.group)
    packed = _rescaled(acc, m, l, m_max)
    if scatter:
        parts = [p.contiguous() for p in packed.chunk(slots.size, dim=2)]
        packed = torch.empty_like(parts[slots.rank])
        dist.reduce_scatter(packed, parts, op=dist.ReduceOp.SUM,
                            group=slots.group)
    else:
        packed = packed.contiguous()
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=slots.group)
    return _divided(packed)


# ------------------------------------------------ sequence parallelism ----
@contextlib.contextmanager
def sequence_parallel(tp: Optional[TensorParallel]):
    """Within, the blocks run sequence-parallel over the 'model' group
    ``tp`` (``None``: they do not)."""
    token = _SP.set(tp)
    try:
        yield
    finally:
        _SP.reset(token)


def sp_group() -> Optional[TensorParallel]:
    """The 'model' group of the sequence-parallel forward running, else
    ``None``."""
    return _SP.get()


def _positions(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The rank's ``S/tp`` contiguous positions of ``x`` (dim 1)."""
    n = x.shape[1] // tp.size
    return x.narrow(1, tp.rank * n, n)


def _gather_seq(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=1)


def _reduce_scatter_seq(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` summed over the 'model' group, the rank's positions kept: one
    c10d reduce-scatter (gloo runs it on CPU and CUDA tensors)."""
    import torch.distributed as dist

    parts = [p.contiguous() for p in x.chunk(tp.size, dim=1)]
    out = torch.empty_like(parts[tp.rank])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=tp.group)
    return out


class _ScatterToSP(torch.autograd.Function):
    """The rank's positions of a replicated tensor forward; the ranks'
    gradients all-gathered along S in backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _positions(x, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.tp), None


class _GatherFromSP(torch.autograd.Function):
    """The ranks' positions all-gathered along S forward (a block part's
    input); the partial gradients summed and scattered back to the
    positions (reduce-scatter) in backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.tp), None


class _ReduceScatterToSP(torch.autograd.Function):
    """The partial sums of a row-parallel part summed over 'model' and cut
    to the rank's positions forward (reduce-scatter); the positions'
    gradients all-gathered along S in backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.tp), None


def scatter_to_sp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """The rank's positions of the replicated ``x`` (``x`` itself without
    ``tp``)."""
    return x if tp is None else _ScatterToSP.apply(x, tp)


def gather_from_sp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """Every position of the sequence-parallel ``x`` (``x`` itself without
    ``tp``)."""
    return x if tp is None else _GatherFromSP.apply(x, tp)


def reduce_scatter_to_sp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """``x`` summed over 'model', the rank's positions (``x`` itself
    without ``tp``)."""
    return x if tp is None else _ReduceScatterToSP.apply(x, tp)


def sum_over_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """A split part's partial result summed over its 'model' group: the
    rank's positions of the sum in a sequence-parallel forward
    (:func:`reduce_scatter_to_sp`), else the whole sum
    (:func:`reduce_from_tp`)."""
    if tp is None:
        return x
    return (reduce_scatter_to_sp(x, tp) if sp_group() is not None
            else reduce_from_tp(x, tp))


def enter_tp(x: torch.Tensor, tp: Optional[TensorParallel]):
    """A block part's input into its tensor-parallel computation:
    :func:`copy_to_tp`, except in a sequence-parallel forward, where the
    input was gathered by :func:`gather_from_sp`, whose backward sums the
    ranks' partial gradients already."""
    return x if sp_group() is not None else copy_to_tp(x, tp)


def sp_shard(x: torch.Tensor, tp: Optional[TensorParallel]):
    """The rank's positions of ``x`` (``x`` itself without ``tp``): of the
    tokens, labels and masks, or of a part's output that every rank
    computed whole. A plain narrow: the positions' gradient reaches the
    whole output, and the part's parameters and input take only their
    share of it, summed over 'model' later."""
    return x if tp is None else _positions(x, tp)
