"""Sharding rules: map every parameter / batch / cache tensor of the LM
path to a placement on a mesh (counterpart of
``repro.distributed.sharding``).

Strategy (the reference's):
  * batch axis            -> ('pod', 'data')   (pure DP across pods)
  * params, dim "in"      -> 'data'            (FSDP / ZeRO-3: gathered
                                                before each use)
  * params, dim "out/TP"  -> 'model'           (tensor parallelism: heads,
                                                ffn hidden, vocab)
  * MoE expert axis       -> 'model' when divisible (EP), else TP fallback
  * decode KV cache seq   -> 'model'           (flash-decoding style)

A spec is a tuple with one entry a tensor dimension: a mesh-axis name, a
tuple of names, or ``None`` (replicated) — the ``PartitionSpec``
analogue. Every axis assignment is divisibility-guarded: a dimension that
does not divide the mesh axis degrades to replication on that axis, so one
rule set serves all 10 architectures (e.g. grok's 8 experts vs deepseek's
160).

A mesh is anything with axis sizes: a
:class:`~repro_torch.launch.mesh.MeshShape` (the production meshes, by
shape) or a real ``torch.distributed.device_mesh.DeviceMesh``. On the
latter, :func:`placements` turns a spec into DTensor placements and
:func:`distribute_model` places a model's parameters; the parameter names
are the state dict's (the reference's paths with ``.`` for ``/``, one
module a layer, no stacked axis).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "batch_spec",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "opt_state_shardings",
    "axis_size",
    "mesh_axes",
    "placements",
    "local_shape",
    "full_tensor",
    "distribute_model",
    "placed_forward",
]


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a mesh, in order: a ``DeviceMesh``'s
    ``mesh_dim_names`` and shape, else the mesh's own ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        size = 1
        for n in name:
            size *= axis_size(mesh, n)
        return size
    return mesh_axes(mesh).get(name, 1)


def _fit(mesh, dim: int, name) -> Optional[str]:
    """Axis name if the dim divides the axis size, else None (replicate)."""
    if name is None:
        return None
    return name if dim % axis_size(mesh, name) == 0 else None


def _dp_axes(mesh):
    """The data-parallel axes present: a tuple of names, the bare name
    when there is one (as a ``PartitionSpec`` normalizes it), or None."""
    axes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_spec(mesh) -> tuple:
    return (_dp_axes(mesh),)


def _spec_for_param(mesh, name: str, x) -> tuple:
    """The spec of one parameter: ``name`` its state-dict name (or the
    reference's ``/`` path), ``x`` anything with a ``shape``."""
    path = name.replace(".", "/")
    shape = tuple(x.shape)
    nd = len(shape)

    def mat(tp_last: bool) -> tuple:
        axes = [None] * nd
        if nd >= 2:
            tp_dim = nd - 1 if tp_last else nd - 2
            fs_dim = nd - 2 if tp_last else nd - 1
            axes[tp_dim] = _fit(mesh, shape[tp_dim], "model")
            axes[fs_dim] = _fit(mesh, shape[fs_dim], "data")
        return tuple(axes)

    if "embed" in path or "lm_head" in path:
        # (V, d) / (d, V): vocab-parallel + FSDP
        vdim = 0 if "embed" in path and "lm_head" not in path else nd - 1
        axes = [None] * nd
        axes[vdim] = _fit(mesh, shape[vdim], "model")
        other = nd - 1 - vdim
        axes[other] = _fit(mesh, shape[other], "data")
        return tuple(axes)

    if "router" in path:
        return tuple([None] * (nd - 1) + [_fit(mesh, shape[-1], "model")])

    # stacked expert weights (E, d, ff) / (E, ff, d): EP over 'model'. MoE
    # weights sit directly under "mlp/" as raw tensors (no "/w" suffix),
    # which tells them from a dense MLP's weights.
    if path.endswith(("mlp/wi", "mlp/wg", "mlp/wo")) and nd >= 3:
        e_ax = _fit(mesh, shape[-3], "model")
        axes = [None] * nd
        axes[-3] = e_ax
        if e_ax is None:
            # EP impossible (e.g. grok's 8 experts on a 16-wide axis):
            # fall back to TP on the ff dim + FSDP on the d dim.
            hid = nd - 2 if path.endswith("wo") else nd - 1  # ff dim
            oth = nd - 1 if path.endswith("wo") else nd - 2  # d dim
            axes[hid] = _fit(mesh, shape[hid], "model")
            axes[oth] = _fit(mesh, shape[oth], "data")
        else:
            axes[-2] = _fit(mesh, shape[-2], "data")
        return tuple(axes)

    # projections whose OUTPUT is the TP dim
    if any(k in path for k in ("wq", "wk", "wv", "wg", "wi", "wq_b", "wk_b",
                               "wv_b", "w_in", "w_gate_in", "cm_k", "wa",
                               "wx", "wr")):
        if nd >= 2:
            return mat(tp_last=True)
        return (_fit(mesh, shape[-1], "model"),)

    # projections whose INPUT is the TP dim
    if any(k in path for k in ("wo", "w_out", "cm_v", "cm_r")):
        if nd >= 2:
            return mat(tp_last=False)
        return (None,)

    # everything else (norm scales, biases, gates, decay params): replicate
    return tuple([None] * nd)


def _named_tensors(model_or_state) -> dict:
    if isinstance(model_or_state, torch.nn.Module):
        return dict(model_or_state.named_parameters())
    return dict(model_or_state)


def _drop_data(spec: tuple) -> tuple:
    return tuple(None if a == "data" or (isinstance(a, tuple) and "data" in a)
                 else a for a in spec)


def param_shardings(mesh, model_or_state, fsdp: bool = True) -> dict:
    """``{name: spec}`` for a model's parameters (or a state dict of
    tensors, ``meta`` ones included).

    ``fsdp=False`` replicates over the 'data' axis (pure TP): the serving
    configuration for models whose TP-sharded weights fit, where per-step
    weight regathers are pure overhead."""
    out = {}
    for name, x in _named_tensors(model_or_state).items():
        spec = _spec_for_param(mesh, name, x)
        out[name] = spec if fsdp else _drop_data(spec)
    return out


def batch_shardings(mesh, batch: dict) -> dict:
    """``{key: spec}``: the leading (batch) axis over the DP axes where it
    divides them (long_500k's batch of 1 rides replicated)."""
    bs = batch_spec(mesh)

    def spec(x):
        nd = len(x.shape)
        first = _fit(mesh, x.shape[0], bs[0]) if nd else None
        return tuple([first] + [None] * (nd - 1)) if nd else ()

    return {k: spec(x) for k, x in batch.items()}


def cache_shardings(mesh, cache: list, min_seq_to_shard: int = 0) -> list:
    """One dict of specs a layer for the port's cache (one dict a layer,
    no stacked axis): batch -> DP axes, a KV cache's sequence axis ->
    'model' (flash-decoding: every model shard owns a slice of the
    history); recurrent states (rwkv ``S``, rglru ``h`` / ``conv``) shard
    batch + head/width.

    ``min_seq_to_shard``: sequence axes shorter than this replicate over
    'model' instead — seq-sharding a 2048-slot ring cache only buys
    per-step gathers."""
    dp = _dp_axes(mesh)

    def spec(leaf, x):
        nd = len(x.shape)
        axes = [None] * nd
        if nd > 0:
            axes[0] = _fit(mesh, x.shape[0], dp)
        if leaf in ("k", "v", "ckv", "krope", "pos") and nd > 1:
            if x.shape[1] >= min_seq_to_shard:
                axes[1] = _fit(mesh, x.shape[1], "model")
        elif leaf in ("S", "h", "conv") and nd > 1:
            axes[1] = _fit(mesh, x.shape[1], "model")
        return tuple(axes)

    return [{leaf: spec(leaf, x) for leaf, x in layer.items()}
            for layer in cache]


def opt_state_shardings(mesh, opt_state, params_sh: dict) -> dict:
    """AdamW's moments shard as their parameters; the step replicates."""
    return {"m": params_sh, "v": params_sh, "step": ()}


# ------------------------------------------------------- DTensor placement ----
def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: for each mesh
    dimension, ``Shard(d)`` of the tensor dimension whose spec entry names
    it (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(mesh, spec: tuple, shape) -> tuple:
    """One rank's shard shape of a tensor of ``shape`` under ``spec``:
    every sharded dimension divided by its axes' size (the guard above
    makes the division exact)."""
    out = []
    for dim, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        out.append(dim // axis_size(mesh, a) if a is not None else dim)
    return tuple(out)


def full_tensor(dt) -> torch.Tensor:
    """The whole tensor of an evenly sharded DTensor on every rank, by
    c10d ``all_gather`` over each sharded mesh dimension's group, the
    innermost first. (``DTensor.full_tensor`` takes the functional
    collectives' path, which ends in a segmentation fault when gloo ranks
    hold CUDA tensors: torch 2.11 on the H100.)"""
    import torch.distributed as dist

    x = dt.to_local()
    mesh = dt.device_mesh
    for mdim in reversed(range(mesh.ndim)):
        p = dt.placements[mdim]
        if p.is_shard():
            group = mesh.get_group(mdim)
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=p.dim)
    return x


def distribute_model(model: torch.nn.Module, mesh, specs: dict) -> None:
    """Place every parameter of ``model`` (in place) as a DTensor on the
    ``DeviceMesh`` ``mesh`` by its spec in ``specs``
    (:func:`param_shardings`), and gather them around each forward, as
    GSPMD's FSDP all-gathers do: each unit (every entry of the model's
    module lists, i.e. every layer, and the model with the rest) replaces
    its parameters by their full tensors before its forward and puts the
    DTensors back after it. Forward (serving) only: the gathered tensors
    carry no gradient to the shards."""
    from torch.distributed.tensor import distribute_tensor

    holders = {}
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        dt = distribute_tensor(p.detach(), mesh, placements(mesh, specs[name]))
        mod._parameters[leaf] = torch.nn.Parameter(
            dt, requires_grad=p.requires_grad)
        holders[name] = (mod, leaf)

    units = []  # (layer, its parameters' names)
    for prefix, child in model.named_children():
        if isinstance(child, torch.nn.ModuleList):
            for i, layer in enumerate(child):
                units.append((layer, [n for n in holders
                                      if n.startswith(f"{prefix}.{i}.")]))
    in_layers = {n for _, names in units for n in names}
    units.append((model, [n for n in holders if n not in in_layers]))

    def hooks(names):
        def gather(module, args):
            for n in names:
                mod, leaf = holders[n]
                dt = mod._parameters[leaf]
                mod._sharded = getattr(mod, "_sharded", {})
                mod._sharded[leaf] = dt
                mod._parameters[leaf] = torch.nn.Parameter(
                    full_tensor(dt), requires_grad=False)

        def reshard(module, args, out):
            for n in names:
                mod, leaf = holders[n]
                mod._parameters[leaf] = mod._sharded.pop(leaf)

        return gather, reshard

    for unit, names in units:
        gather, reshard = hooks(names)
        unit.register_forward_pre_hook(gather)
        unit.register_forward_hook(reshard)


def placed_forward(rank, arch: str, mesh_shape: tuple, tokens,
                   smoke: bool = True) -> dict:
    """One rank of a forward with placed parameters, the function
    :func:`~repro_torch.launch.mesh.spawn_ranks` runs on every rank:
    ``arch``'s model (its smoke config with ``smoke``) from its own seeded
    initialization on the rank's device, placed by :func:`param_shardings`
    on a ``DeviceMesh`` of ``mesh_shape`` over ("data", "model") and run
    once on ``tokens`` (B, S). Returns the logits (numpy, f32), each
    parameter's spec and its local shard shape."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import LanguageModel, forward

    cfg = (get_smoke_config if smoke else get_config)(arch)
    dev = rank.device
    mesh = init_device_mesh(dev.type, tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    model = LanguageModel(cfg, device=dev)
    specs = param_shardings(mesh, model)
    distribute_model(model, mesh, specs)
    local = {name: tuple(p.to_local().shape)
             for name, p in model.named_parameters()}
    with torch.inference_mode():
        logits, _ = forward(model, {"tokens": torch.as_tensor(
            np.asarray(tokens), device=dev)})
    return {"logits": logits.float().cpu().numpy(), "specs": specs,
            "local_shapes": local}
