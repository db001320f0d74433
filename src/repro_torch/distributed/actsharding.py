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
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.distributed.sharding import axis_size, mesh_axes, placements

__all__ = ["activation_sharding", "shard_act", "current_mesh"]

# (mesh, sp) of the innermost activation_sharding, None outside one
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_sharding", default=None)


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
