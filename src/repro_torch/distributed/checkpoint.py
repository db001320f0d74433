"""Atomic checkpoints with keep-last-k pruning (counterpart of
``repro.distributed.checkpoint``), in the reference's layout:

    <dir>/step_<N:012d>/
        manifest.json   step, sorted flat keys, shapes, dtypes, extra
        arrays.npz      one entry per leaf, nested keys joined with "::"

A tree is nested dicts (and lists or tuples) of tensors, e.g. the training
state ``{"params": model.state_dict(), "opt": {"m", "v", "step"}}``.
Leaves are stored whole on the host; bf16 and float8 are widened to f32
(npz has no such dtype) and cast back to the template's dtype on restore,
which is exact. A checkpoint is written into ``step_<N>.tmp`` and
published by ``os.rename``, so a failed writer never leaves a partial
checkpoint visible. Restore lands every leaf on ``device`` (default: the
template leaf's), whatever device wrote it.

A placed tree (DTensor leaves: a placed model's parameters and AdamW
moments) is saved whole: every rank gathers each leaf
(:func:`~repro_torch.distributed.sharding.full_tensor`), rank 0 writes,
and the ranks meet at a barrier, so the layout is the reference's. The
elastic restore, ``restore_checkpoint(..., shardings=, mesh=)``, puts
each leaf onto its placement on ``mesh``, whatever mesh saved it.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import full_tensor, is_placed, place

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "available_steps"]

_SEP = "::"


def _leaves(tree, prefix=()):
    """(key path, leaf) pairs of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, prefix + (str(k),))


def _rebuild(tree, values: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values[prefix]


def _host(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach()
    if t.dtype == torch.bfloat16 or "float8" in str(t.dtype):
        t = t.float()  # npz has no such dtype: widened, exact
    return t.cpu().numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, keep: int = 3,
                    extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` for ``step``; prune to the newest
    ``keep``. Returns the checkpoint's directory. A tree with DTensor
    leaves is a collective: every rank of their mesh calls this, each leaf
    is gathered whole, rank 0 writes, and every rank returns once the
    checkpoint is published."""
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    flat, placed = {}, False
    for path, leaf in _leaves(tree):
        if is_placed(leaf):
            leaf, placed = full_tensor(leaf), True
        flat[_SEP.join(path)] = _host(leaf)
    if not placed:
        _write(ckpt_dir, final, step, flat, keep, extra)
        return final
    import torch.distributed as dist

    if dist.get_rank() == 0:
        _write(ckpt_dir, final, step, flat, keep, extra)
    dist.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, flat: dict, keep: int,
           extra: Optional[dict]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    for s in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"),
                      ignore_errors=True)


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _at(tree, path):
    """The entry of ``tree`` (nested dicts and lists) at a key path."""
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None,
                       device: Union[str, torch.device, None] = None,
                       shardings: Any = None, mesh=None
                       ) -> tuple[Any, int]:
    """Restore ``step`` (default: the latest) into the structure of
    ``template``: each leaf at the template leaf's dtype, on ``device``
    (default: the template leaf's device). Returns ``(tree, step)``.

    ``shardings`` (a tree of specs matching ``template``, e.g.
    ``{"params": param_shardings(mesh, model), "opt":
    opt_state_shardings(...)}``) with the ``DeviceMesh`` ``mesh``: the
    elastic path. Each leaf becomes a DTensor placed by its spec on
    ``mesh`` (:func:`~repro_torch.distributed.sharding.place`; each rank
    keeps its shard, nothing is sent), whatever mesh saved it; a 0-d leaf
    (the step counter) stays a plain tensor, whole on every rank."""
    if shardings is not None and mesh is None:
        raise ValueError("shardings place the leaves on a mesh: pass mesh=")
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:012d}", "arrays.npz")
    values = {}
    with np.load(path) as data:
        for kpath, leaf in _leaves(template):
            arr = torch.from_numpy(np.asarray(data[_SEP.join(kpath)]))
            like = torch.as_tensor(leaf)
            t = arr.to(device=device or like.device, dtype=like.dtype)
            if shardings is not None and t.dim():
                t = place(t, mesh, _at(shardings, kpath))
            values[kpath] = t
    return _rebuild(template, values), step
