"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): top-k
routing with a per-expert capacity, dispatched either GShard-style (one-hot
dispatch and combine einsums) or by sorting (``moe_impl="sort"``: argsort
and gathers, MegaBlocks-style), plus DeepSeek-V2's shared experts and the
router's load-balancing auxiliary loss.

Capacity is ``max(int(S * k / E * capacity_factor), 1)`` for a call of S
tokens, per batch row (a row is a group); a (token, choice) entry past its
expert's capacity is dropped. Both dispatches drop by queue position, the
GShard one in token order and the sort one in sorted order (the same order:
the sort is stable). The router stays f32 whatever the parameter dtype.

Placed on a 'model' axis where the layer splits
(:func:`~repro_torch.distributed.tensor_parallel.moe_splits`), each rank
routes all its tokens alike (the router, top-k, capacity and the aux loss
are every rank's), then computes only its part: its ``E/tp`` experts on
the slots routing gave them (expert parallelism), or every expert's
``e_ff/tp`` ff columns; the shared expert its columns. The partial combine
and shared output are summed by one all-reduce (a reduce-scatter to the
rank's positions under sequence parallelism, whose block hands the layer
every position). The ranks along 'model' hold the same tokens, so no
token moves: this is what GSPMD makes of the reference's dispatch
sharding when the tokens are replicated along 'model'. The all-to-all
dispatch is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.actsharding import dp_active, dp_sum, shard_act
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     enter_tp, moe_splits,
                                                     shared_expert_splits,
                                                     sp_group, sp_shard,
                                                     sum_over_tp)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Init

__all__ = ["MoE", "moe_capacity"]


class _ShareGrad(torch.autograd.Function):
    """Identity forward; the gradient divided by ``n`` in backward (a
    value every one of ``n`` ranks computes alike, whose gradients the
    ranks sum)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and batch row for a call of ``S`` tokens, evaluated
    in the reference's order (float rounding of the product decides it)."""
    return max(int(S * cfg.top_k / cfg.num_experts * cfg.capacity_factor), 1)


class MoE(nn.Module):
    """Routed SwiGLU experts, stacked as ``wi``/``wg`` (E, d, e_ff) and
    ``wo`` (E, e_ff, d), the f32 ``router`` (d, E) and, with
    ``num_shared_experts``, one dense SwiGLU ``shared`` of width
    ``e_ff · num_shared_experts`` that every token runs. ``forward`` returns
    ``(y, aux_loss)``.

    With a 'model' group ``tp`` (set by
    :func:`~repro_torch.distributed.sharding.distribute_model`) the expert
    stacks are the rank's: its ``E/tp`` experts, or every expert's ff
    columns; ``shared`` its columns where its width divides (it then runs
    without a group of its own: its partial joins the layer's one sum)."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        d, E = cfg.d_model, cfg.num_experts
        e_ff = cfg.moe_d_ff or cfg.d_ff
        self.router = init.normal((d, E), d ** -0.5, dtype=torch.float32)
        self.wi = init.normal((E, d, e_ff), d ** -0.5)
        self.wg = init.normal((E, d, e_ff), d ** -0.5)
        self.wo = init.normal((E, e_ff, d), e_ff ** -0.5)
        self.shared = (MLP(d, e_ff * cfg.num_shared_experts, "swiglu", init)
                       if cfg.num_shared_experts else None)
        self.tp: Optional[TensorParallel] = None

    def _held(self) -> Tuple[int, int]:
        """The experts ``[lo, hi)`` whose slots this rank computes: its
        ``E/tp`` under expert parallelism, else all of them."""
        E, tp = self.cfg.num_experts, self.tp
        if tp is None or moe_splits(self.cfg, tp.size) != "expert":
            return 0, E
        n = E // tp.size
        return tp.rank * n, (tp.rank + 1) * n

    def _experts(self, xe):
        """The SwiGLU of every expert on its slots: (B, E, C, d), experts
        on EP."""
        xe = shard_act(xe, "dp", "model", None, None)  # tokens to experts
        h = torch.einsum("becd,edf->becf", xe, self.wi)
        g = torch.einsum("becd,edf->becf", xe, self.wg)
        h = shard_act(F.silu(g) * h, "dp", "model", None, None)
        return torch.einsum("becf,efd->becd", h, self.wo)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d). Returns (y (B, S, d), aux_loss (f32 scalar))."""
        cfg = self.cfg
        E, k = cfg.num_experts, cfg.top_k
        capacity = moe_capacity(cfg, x.shape[1])
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(),
                                           self.router), dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (B, S, k)
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
        dispatch = self._sorted if cfg.moe_impl == "sort" else self._gshard
        tp = self.tp
        # only what enters the rank's partial sum crosses into 'model': the
        # router's x does not, or its gradient would be summed tp times
        xs, gates = enter_tp(x, tp), enter_tp(gate_vals, tp)
        y = dispatch(xs, gates, gate_idx, capacity)
        whole = None
        if self.shared is not None:
            if tp is None or shared_expert_splits(cfg, tp.size):
                y = y + self.shared(xs)
            else:  # every rank's, its positions kept under SP
                whole = sp_shard(self.shared(x), sp_group())
        y = sum_over_tp(y, tp)
        if whole is not None:
            y = y + whole
        return y, self._aux_loss(probs, gate_idx)

    def _aux_loss(self, probs, gate_idx):
        """Switch's load-balancing loss, E · Σ_e f_e p_e · router_aux_coef:
        f_e the share of first choices, p_e the mean probability, both over
        the global batch: in a placed training step (``dp_active``) the
        rank's sums and token count are summed over the data-parallel
        ranks, with gradient, before the product. Under sequence
        parallelism every 'model' rank computes it alike from every
        position, while its other gradients reach the router and the
        input as the rank's share, summed over 'model' later: the loss's
        gradient is shared out the same way (1/tp a rank)."""
        E = self.cfg.num_experts
        first = F.one_hot(gate_idx[..., 0], E).float()
        if dp_active():
            n = probs.new_full((1,), float(first.shape[0] * first.shape[1]))
            tot = dp_sum(torch.cat([first.sum((0, 1)), probs.sum((0, 1)), n]))
            frac_tokens, frac_probs = tot[:E] / tot[-1], tot[E:-1] / tot[-1]
        else:
            frac_tokens = first.mean((0, 1))
            frac_probs = probs.mean((0, 1))
        aux = E * (frac_tokens * frac_probs).sum() * self.cfg.router_aux_coef
        sp = sp_group()
        return aux if sp is None else _ShareGrad.apply(aux, sp.size)

    def _gshard(self, x, gate_vals, gate_idx, capacity):
        B, S, _ = x.shape
        E, k = self.cfg.num_experts, self.cfg.top_k
        # each (token, choice)'s place in its expert's queue: s outer, k inner
        onehot = F.one_hot(gate_idx, E)  # (B, S, k, E)
        flat = onehot.reshape(B, S * k, E)
        pos = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(B, S, k)
        # past capacity: an all-zero slot one-hot, the entry dropped
        slots = torch.arange(capacity, device=x.device)
        pos_oh = (pos[..., None] == slots).to(x.dtype)  # (B, S, k, C)
        lo, hi = self._held()
        exp_oh = onehot[..., lo:hi].to(x.dtype)  # the rank's experts
        dispatch = torch.einsum("bske,bskc->bsec", exp_oh, pos_oh)
        combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals.to(x.dtype),
                               exp_oh, pos_oh)
        dispatch = shard_act(dispatch, "dp", None, "model", None)
        combine = shard_act(combine, "dp", None, "model", None)
        xe = torch.einsum("bsd,bsec->becd", x, dispatch)  # (B, E, C, d)
        y = torch.einsum("becd,bsec->bsd", self._experts(xe), combine)
        return shard_act(y, "dp", None, None)

    def _sorted(self, x, gate_vals, gate_idx, capacity):
        """Sort and gather, each batch row a group: the (token, choice)
        entries sorted stably by expert, an expert's queue position its
        rank among them, entries at or past capacity sent to the overflow
        slot (zeroed, then scaled by 0), as are the entries of experts
        another rank holds under expert parallelism. The outputs return to
        token order through the inverse permutation and sum over the k
        choices: no scatter-add, so no atomics."""
        B, S, d = x.shape
        E, k, C = self.cfg.num_experts, self.cfg.top_k, capacity
        lo, hi = self._held()
        dev = x.device
        flat_e = gate_idx.reshape(B, S * k)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        e_sorted = flat_e.gather(1, order)
        tok_sorted = order // k  # entry s·k + j belongs to token s
        gate_sorted = gate_vals.reshape(B, S * k).gather(1, order)
        start = torch.searchsorted(
            e_sorted, torch.arange(E, device=dev).expand(B, E).contiguous(),
            side="left")
        pos = torch.arange(S * k, device=dev) - start.gather(1, e_sorted)
        keep = (pos < C) & (e_sorted >= lo) & (e_sorted < hi)
        held = hi - lo  # the experts whose slots this rank holds
        dest = torch.where(keep, (e_sorted - lo) * C + pos, held * C)
        rows = torch.arange(B, device=dev)[:, None]
        buf = torch.zeros((B, held * C + 1, d), dtype=x.dtype, device=dev)
        # kept entries have distinct slots; the overflow slot only takes
        # zeros and is cut off
        buf[rows, dest] = x[rows, tok_sorted] * keep[..., None].to(x.dtype)
        ye = self._experts(buf[:, :-1].reshape(B, held, C, d))
        ye = torch.cat([ye.reshape(B, held * C, d),
                        ye.new_zeros((B, 1, d))], dim=1)
        contrib = ye[rows, dest] * (gate_sorted * keep)[..., None].to(ye.dtype)
        inverse = torch.argsort(order, dim=-1)
        y = contrib[rows, inverse].reshape(B, S, k, d).sum(2)
        return shard_act(y, "dp", None, None)
