"""Activation sharding constraints inside the LM path (counterpart of
``repro.distributed.actsharding``).

The model code calls :func:`shard_act` at the reference's points (the
chunked attention's operands, the MoE dispatch, the RWKV-6 chunking).
Outside :func:`activation_sharding` it returns its argument itself, so
single-device runs are untouched bit for bit. Inside one, an activation
that is a DTensor on the mesh is redistributed to the spec; a plain tensor
(the placed models of :func:`~repro_torch.distributed.sharding.distribute_model`
gather their weights and compute on plain tensors) passes unchanged.

Specs are divisibility-guarded like everything in sharding.py: an axis
that does not divide degrades to replication rather than erroring.

:func:`data_parallel` marks a placed training step: inside it,
:func:`dp_sum` sums a batch statistic over the data-parallel ranks of the
mesh (the loss's numerators and denominator, the MoE load-balancing
means), which GSPMD does for the reference. Outside one it returns its
argument itself, so one process's arithmetic is unchanged bit for bit.
:func:`recompute_contexts` carries both contexts, and the sequence-parallel
group of the forward
(:func:`~repro_torch.distributed.tensor_parallel.sequence_parallel`), into
a ``remat`` block's recomputation, which runs in backward, outside the
step's ``with``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.sharding import (axis_size, dp_all_reduce,
                                              mesh_axes, placements)

__all__ = ["activation_sharding", "shard_act", "current_mesh",
           "data_parallel", "dp_sum", "dp_active", "recompute_contexts"]

# (mesh, sp) of the innermost activation_sharding, None outside one
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_sharding", default=None)
# the DeviceMesh of the innermost data_parallel, None outside one
_DP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_data_parallel", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, sp: bool = True):
    """Enable activation constraints for code run within.

    ``sp``: Megatron-style sequence parallelism — the literal axis name
    "sp" in shard_act calls resolves to 'model', sharding inter-block
    activations along the sequence.
    """
    token = _ACTIVE.set((mesh, sp) if mesh is not None else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_mesh():
    active = _ACTIVE.get()
    return active[0] if active is not None else None


def _resolve(mesh, sp: bool, shape, axes) -> tuple:
    spec = []
    names = mesh_axes(mesh)
    for dim, a in zip(shape, axes):
        if a == "dp":
            a = tuple(n for n in ("pod", "data") if n in names)
            a = a if len(a) > 1 else (a[0] if a else None)
        elif a == "sp":
            a = "model" if sp else None
        if a is not None and dim % axis_size(mesh, a) != 0:
            a = None
        spec.append(a)
    return tuple(spec)


def shard_act(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain ``x`` to the spec ``axes`` on the active mesh.

    ``axes`` entries: mesh axis name, tuple of names, or None; 'dp' expands
    to the data-parallel axes present in the mesh (('pod', 'data')), 'sp'
    to 'model' under sequence parallelism.
    """
    active = _ACTIVE.get()
    if active is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, sp = active
    spec = _resolve(mesh, sp, x.shape, axes)
    return x.redistribute(x.device_mesh, placements(mesh, spec))


@contextlib.contextmanager
def data_parallel(mesh):
    """Within, :func:`dp_sum` sums over the data-parallel ranks of the
    ``DeviceMesh`` ``mesh`` (``None``: no reduction)."""
    token = _DP.set(mesh)
    try:
        yield
    finally:
        _DP.reset(token)


class _DPSum(torch.autograd.Function):
    """All-reduce over the data-parallel ranks. The objective built on the
    sum is the same on every rank, and each rank differentiates it through
    its own rows only, so the gradient passes unchanged; the shards'
    gradients are summed over the ranks where the weights are gathered
    (``sharding._Gather``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return dp_all_reduce(x.clone(memory_format=torch.contiguous_format),
                             mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel ranks inside
    :func:`data_parallel`, with its gradient; ``x`` itself outside one."""
    mesh = _DP.get()
    return x if mesh is None else _DPSum.apply(x, mesh)


def dp_active() -> bool:
    """Whether a :func:`data_parallel` block is active."""
    return _DP.get() is not None


def recompute_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: the recomputation in
    backward runs under the activation constraints, the data-parallel
    group and the sequence-parallel group that were active when the
    forward ran."""
    state = (_ACTIVE.get(), _DP.get(), tensor_parallel.sp_group())

    @contextlib.contextmanager
    def restored():
        tokens = (_ACTIVE.set(state[0]), _DP.set(state[1]))
        try:
            with tensor_parallel.sequence_parallel(state[2]):
                yield
        finally:
            _DP.reset(tokens[1])
            _ACTIVE.reset(tokens[0])

    return contextlib.nullcontext(), restored()
