"""The training step (counterpart of ``repro.train.train_step``): the LM
loss (CE + z-loss + MoE aux), its gradient by autograd, microbatched
gradient accumulation, an optional gradient transform (compression), and
the AdamW update.

The same step serves decoder LMs (next token), the encoder-only audio arch
(per-frame labels from the batch) and the VLM backbone (vision
embeddings and positions in the batch dict). ``train_step(model,
opt_state, batch)`` updates the model's parameters and the optimizer
state in place (the reference donates them) and returns them with the
metrics, f32 tensors on the device (no host synchronization).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.distributed.actsharding import (data_parallel, dp_active,
                                                 dp_sum)
from repro_torch.distributed.sharding import (is_placed, local_tensor,
                                              placed_like)
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     reduce_from_tp)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES
from repro_torch.models.model import LanguageModel
from repro_torch.train.optimizer import OptimizerConfig, adamw_update

__all__ = ["TrainConfig", "loss_fn", "make_train_step", "trainable",
           "cross_entropy", "vocab_parallel_lse"]

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    remat: bool = True
    grad_accum: int = 1  # microbatches per step
    accum_dtype: str = "float32"  # the accumulator's; "bfloat16" halves it
    z_loss_coef: float = 1e-4
    grad_transform: Optional[Callable] = None  # e.g. compression
    attn_args: Optional[dict] = None  # chunk sizes / skip_masked_blocks


def vocab_parallel_lse(logits: torch.Tensor, labels: torch.Tensor,
                       tp: TensorParallel):
    """``(lse, gold)`` of logits whose last axis holds the rank's
    contiguous vocab columns (the rank's part of the whole logits): the
    per-token log-sum-exp over the whole vocab and the label's logit, each
    (rows, S) f32 on every 'model' rank. The per-token max over the rank's
    columns is all-reduced with MAX (it takes no gradient); the sums of
    ``exp(logit - max)`` over the rank's columns and the gold logit (from
    the rank whose columns hold the label, zero elsewhere) are summed over
    'model' in one all-reduce (:func:`reduce_from_tp`), so that each rank's
    gradient reaches its own columns alone: their softmax and the label's
    one-hot."""
    import torch.distributed as dist

    m = logits.detach().amax(-1).contiguous()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    sumexp = torch.exp(logits - m[..., None]).sum(-1)
    n = logits.shape[-1]
    local = labels - tp.rank * n
    mine = (local >= 0) & (local < n)
    gold = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    sumexp, gold = reduce_from_tp(
        torch.stack([sumexp, torch.where(mine, gold, 0.0)]), tp).unbind()
    return m + torch.log(sumexp), gold


def loss_fn(model: LanguageModel, batch: dict, tcfg: TrainConfig):
    """Mean CE over the unmasked tokens (+ z-loss + MoE aux) of one forward
    without a cache. Returns ``(total, {"ce", "z_loss", "moe_aux"})``.
    Inside :func:`~repro_torch.distributed.actsharding.data_parallel` the
    numerators and the token count are summed over the data-parallel ranks
    first (one all-reduce): the global batch's mean, not a mean of the
    ranks' means. A placed model with a split vocab keeps the rank's
    columns of the logits (``gather_logits=False``), whose log-sum-exp and
    gold logit :func:`vocab_parallel_lse` sums over 'model' (the
    vocab-parallel cross-entropy)."""
    logits, _, aux = model(batch, remat=tcfg.remat,
                           attn_args=tcfg.attn_args, with_aux=True,
                           gather_logits=False)
    dev = logits.device
    labels = batch["labels"].to(dev, torch.int64)
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=dev)
            if mask is None else mask.to(dev, torch.float32))
    vocab = model.tp if model.cfg.has_lm_head else None
    ce, zl = cross_entropy(logits, labels, mask, tcfg.z_loss_coef, vocab)
    return ce + zl + aux, {"ce": ce, "z_loss": zl, "moe_aux": aux}


def cross_entropy(logits, labels, mask, z_loss_coef: float,
                  vocab: Optional[TensorParallel] = None):
    """``(ce, z_loss)``: the mean CE of ``logits`` (rows, S, V) over the
    tokens ``mask`` keeps, and ``z_loss_coef`` times the mean squared
    log-sum-exp. ``vocab``: the logits hold the rank's vocab columns of
    that 'model' group (:func:`vocab_parallel_lse`). Inside
    ``data_parallel`` the sums are summed over the data-parallel ranks."""
    logits = logits.float()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
    else:
        lse, gold = vocab_parallel_lse(logits, labels, vocab)
    sums = torch.stack([((lse - gold) * mask).sum(),
                        (lse.square() * mask).sum(), mask.sum()])
    if dp_active():  # a placed step: the global batch's sums
        sums = dp_sum(sums)
    nll, zsq, count = sums.unbind()
    denom = torch.clamp_min(count, 1.0)
    return nll / denom, z_loss_coef * zsq / denom


def trainable(model: LanguageModel) -> dict:
    """The model's parameters by name, with ``requires_grad`` on (they are
    built frozen for serving)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def _grads(loss, params: dict) -> dict:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), gs)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; metrics: ``loss``, its parts (``ce``, ``z_loss``,
    ``moe_aux``; none under accumulation), ``lr`` and ``grad_norm``.

    With ``grad_accum`` k > 1 the batch's leading axis is cut into k
    contiguous microbatches; each one's gradients are added into an
    accumulator at ``accum_dtype`` (not into ``.grad`` at the parameter
    dtype), which is then scaled by 1/k, and the loss is the microbatches'
    mean.

    With a ``DeviceMesh`` ``mesh`` the step is placed: the model's
    parameters are DTensors on it
    (:func:`~repro_torch.distributed.sharding.distribute_model`), the
    AdamW moments too (``adamw_init`` places them as the parameters), and
    ``batch`` holds the rank's rows
    (:func:`~repro_torch.distributed.sharding.local_batch` with k
    microbatches). The step then equals one process's step on the global
    batch: the loss's sums and the MoE means are summed over the
    data-parallel ranks (``data_parallel``), each microbatch's backward
    sums the gathered weights' gradients over them and cuts them to the
    shards (the parts that split over 'model' compute tensor-parallel on
    the rank's 'model' shard), and the gradient norm sums each shard's
    squares over the axes its parameter is sharded on. The accumulation
    and the update run on the local shards. ``remat``'s recomputation runs
    the whole block (``set_checkpoint_early_stop(False)``), so each
    layer's weights are gathered, and its forward all-reduces over
    'model' sent, a second time in every microbatch's backward."""
    k = tcfg.grad_accum
    adt = DTYPES[tcfg.accum_dtype]

    def placed_loss(model, batch):
        if mesh is None:
            return loss_fn(model, batch, tcfg)
        with data_parallel(mesh), set_checkpoint_early_stop(False):
            return loss_fn(model, batch, tcfg)

    def accum_grads(model, params, batch):
        if k <= 1:
            loss, parts = placed_loss(model, batch)
            return loss.detach(), {n: v.detach() for n, v in parts.items()}, \
                _grads(loss, params)
        B = next(iter(batch.values())).shape[0]
        if B % k:
            raise ValueError(f"batch {B} is not a multiple of grad_accum {k}")
        acc = {n: torch.zeros(local_tensor(p).shape, dtype=adt,
                              device=p.device)
               for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(k):
            micro = {n: v[i * (B // k):(i + 1) * (B // k)]
                     for n, v in batch.items()}
            loss, _ = placed_loss(model, micro)
            for n, g in _grads(loss, params).items():
                g = local_tensor(g)
                # a + g.astype(a.dtype): an f32 accumulator widens exactly
                acc[n].add_(g if adt == torch.float32 else g.to(adt))
            loss_sum += loss.detach()
        scale = 1.0 / k
        return loss_sum * scale, {}, {n: placed_like(a.mul_(scale), params[n])
                                      for n, a in acc.items()}

    def train_step(model: LanguageModel, opt_state: dict, batch: dict):
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg.name}, not "
                             f"{model.cfg.name}")
        params = trainable(model)
        if (mesh is not None) != any(is_placed(p) for p in params.values()):
            raise ValueError("a placed step needs a model placed on its mesh "
                             "(distribute_model), and only a placed step "
                             "takes one")
        loss, parts, grads = accum_grads(model, params, batch)
        if tcfg.grad_transform is not None:
            grads = tcfg.grad_transform(grads)
        _, opt_state, om = adamw_update(params, grads, opt_state,
                                        tcfg.optimizer)
        del grads
        return model, opt_state, {"loss": loss, **parts, **om}

    return train_step
