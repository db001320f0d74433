"""AdamW with moments at a chosen dtype, a cosine schedule and a global
gradient clip (counterpart of ``repro.train.optimizer``).

Parameters, gradients and moments are dicts of named tensors (a model's
``named_parameters()``). The arithmetic is the reference's: the step
counter goes up first and the learning rate is taken at the new step; the
gradient norm is the f32 sum of squares over every gradient;
``scale = min(1, clip / max(norm, 1e-9))``; the moments and the update are
computed in f32, ``delta = m̂ / (√v̂ + eps) + wd · p`` with weight decay on
every tensor (norms and embeddings too), the parameter is written back
rounded to its own dtype and the moments to ``moment_dtype``. bf16 moments
(the reference's choice at 100 B parameters and more) halve their bytes.

The update runs in place, under ``no_grad``, on slices of at most
``MAX_SLICE`` elements of each flattened tensor, so its f32 temporaries
stay small beside a stacked expert tensor of a billion elements; every
slice sees the same step, learning rate and scale, so the result does not
depend on the slicing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Union

import torch

from repro_torch.distributed.sharding import (is_placed, local_tensor,
                                              placed_like)
from repro_torch.models.layers import DTYPES

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "MAX_SLICE", "NORM_SLICE"]

MAX_SLICE = 1 << 26  # elements of one tensor updated at a time (~64 M)
# the norm's slices, fixed apart from MAX_SLICE: the order of its f32 sum
# never depends on how the update is sliced
NORM_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" for >=100B configs


def cosine_lr(cfg: OptimizerConfig,
              step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warm-up to ``learning_rate``, then a cosine down to
    ``min_lr_ratio`` of it at ``total_steps``; an f32 tensor on ``step``'s
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict, cfg: OptimizerConfig) -> dict:
    """``{"m", "v"}`` zeros at ``moment_dtype`` beside each parameter (a
    DTensor parameter's placed as it is: ``opt_state_shardings``), and
    ``step`` an int32 0 on the parameters' device."""
    mdt = DTYPES[cfg.moment_dtype]
    dev = next(iter(params.values())).device

    def zeros():
        return {n: placed_like(torch.zeros(local_tensor(p).shape, dtype=mdt,
                                           device=p.device), p)
                for n, p in params.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _slices(n: int, max_slice: int) -> Iterator[slice]:
    for start in range(0, n, max_slice):
        yield slice(start, min(start + max_slice, n))


def global_norm(tensors) -> torch.Tensor:
    """√(Σ g²) over every tensor, squares summed in f32 (in slices of
    NORM_SLICE elements, so no tensor is widened whole).

    A DTensor adds its local shard's squares to the partial sum of the
    tensors sharded over the same mesh dimensions; each partial is then
    summed over exactly those dimensions (one all-reduce a mesh dimension,
    over every partial it shards), so a tensor replicated over an axis is
    counted once. The partials add up in a fixed order."""
    sums, mesh = {}, None
    for g in tensors:
        key = ()
        if is_placed(g):
            mesh = g.device_mesh
            key = tuple(d for d, p in enumerate(g.placements)
                        if p.is_shard() and mesh.size(d) > 1)
        flat = local_tensor(g).detach().reshape(-1)
        for sl in _slices(flat.numel(), NORM_SLICE):
            s = flat[sl].float().square().sum()
            sums[key] = s if key not in sums else sums[key] + s
    if not sums:
        raise ValueError("no gradients")
    if mesh is not None:
        import torch.distributed as dist

        for d in range(mesh.ndim):
            keys = sorted(k for k in sums if d in k)
            if keys:
                v = torch.stack([sums[k] for k in keys])
                dist.all_reduce(v, op=dist.ReduceOp.SUM,
                                group=mesh.get_group(d))
                sums.update(zip(keys, v.unbind()))
    total = None
    for key in sorted(sums):
        total = sums[key] if total is None else total + sums[key]
    return total.sqrt()


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 cfg: OptimizerConfig):
    """One AdamW step, in place on ``params`` and ``state``. Returns
    ``(params, state, {"lr", "grad_norm"})`` (f32 tensors on the device).
    ``grads`` holds a gradient (any float dtype) for every parameter."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for name, p in params.items():
        # a placed step updates each rank's shards: elementwise, no exchange
        pf = local_tensor(p).detach().view(-1)
        gf = local_tensor(grads[name]).reshape(-1)
        mf = local_tensor(state["m"][name]).view(-1)
        vf = local_tensor(state["v"][name]).view(-1)
        for sl in _slices(pf.numel(), MAX_SLICE):
            g = gf[sl].float() * scale
            m32 = cfg.b1 * mf[sl].float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * vf[sl].float() + (1 - cfg.b2) * g.square()
            p32 = pf[sl].float()
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
                + cfg.weight_decay * p32
            pf[sl] = p32 - lr * delta  # rounded to the parameter's dtype
            mf[sl] = m32
            vf[sl] = v32
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
