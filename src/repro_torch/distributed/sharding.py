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

What the placed model computes, as far as this port goes (FSDP, data
parallelism and tensor parallelism over 'model'): each layer gathers its
weights before its forward over the data-parallel axes, and the weights'
gradients reach the shards (summed over the data-parallel ranks, cut to
the rank's shard). Where a block's shapes allow
(:func:`~repro_torch.distributed.tensor_parallel.split_plan`: GQA / MHA
attention and MLA by heads, dense MLPs, MoE layers by experts or by each
expert's ff columns, RG-LRU by width, RWKV-6 by heads, the vocab), each
'model' rank keeps its 'model' shard and computes with it alone, the
activations summed or gathered over the 'model' group
(:mod:`repro_torch.distributed.tensor_parallel`). The other parts (MLA's
latent projections, the MoE router and whatever does not divide) gather
their weights whole along 'model' too, and the ranks along 'model'
compute them alike on the same batch rows. A split MoE layer moves no
token between ranks: every 'model' rank holds all the tokens of its
batch rows, routes them alike and runs its own experts' slots. A forward
whose length divides the 'model' axis (training, prefill) runs
sequence-parallel: between blocks each 'model' rank holds its positions of
the residual stream, and the parameters it uses whole get their gradients
summed over 'model'. A serving
cache holds the rank's batch rows, the rank's KV heads, its block of the
slots where its attention's slot group has more than one rank (MLA's
compressed cache, an attention that does not split, replicated KV heads:
the reference's ``cache_shardings``, decode merging the ranks' partial
softmaxes), its RG-LRU channels and its RWKV-6 heads. Every collective
is a c10d call, which
:func:`repro_torch.launch.roofline.record_collectives` counts and
:func:`repro_torch.launch.analytic.lm_collectives` schedules.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     copy_to_tp, sp_group,
                                                     split_plan)

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
    "data_parallel_dims",
    "is_placed",
    "local_tensor",
    "placed_like",
    "coordinate",
    "shard_of",
    "place",
    "dp_all_reduce",
    "gathered",
    "full_tensor",
    "tensor_parallel",
    "slot_group",
    "distribute_model",
    "local_batch",
    "gather_batch",
    "placed_forward",
    "placed_serve",
    "placed_train_step",
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
    per-step gathers.

    This is the reference's rule, which the dry-run's residency reads: it
    cuts axis 1, so RG-LRU's ``conv`` (B, cw-1, w), whose axis 1 is 3,
    stays whole on 'model'. The placed serving cache
    (``models.init_cache(tp=)``) holds the rank's channels of ``h`` and
    ``conv`` and the rank's heads of ``S`` where those blocks split."""
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


def data_parallel_dims(mesh) -> list:
    """The indices of the mesh's data-parallel dimensions ('pod', 'data')
    of more than one rank: the ranks along them take other batch rows."""
    return [d for d, (name, size) in enumerate(mesh_axes(mesh).items())
            if name in ("pod", "data") and size > 1]


def is_placed(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor placed on a ``DeviceMesh``)."""
    return hasattr(t, "device_mesh") and hasattr(t, "to_local")


def local_tensor(t):
    """This rank's shard of a DTensor (a view of its storage), else ``t``."""
    return t.to_local() if is_placed(t) else t


def placed_like(local: torch.Tensor, like):
    """``local`` as a DTensor placed as ``like`` (one rank's shard of the
    same shape), or ``local`` itself when ``like`` is a plain tensor."""
    if not is_placed(like):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def coordinate(mesh) -> dict:
    """``{axis name: index}`` of this rank on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_of(full: torch.Tensor, mesh, spec: tuple,
             coord: Optional[dict] = None) -> torch.Tensor:
    """The shard of ``full`` that the rank at ``coord`` (``{axis: index}``;
    default: this rank's on a ``DeviceMesh``) holds under ``spec``: each
    dimension cut by its axes, a tuple of axes cut major-first as a
    ``PartitionSpec`` cuts it. A view of ``full``."""
    if coord is None:
        coord = coordinate(mesh)
    out = full
    for dim, a in enumerate(spec):
        n = axis_size(mesh, a) if a is not None else 1
        if n == 1:
            continue
        idx = 0
        for name in (a if isinstance(a, tuple) else (a,)):
            idx = idx * axis_size(mesh, name) + coord.get(name, 0)
        chunk = full.shape[dim] // n
        out = out.narrow(dim, idx * chunk, chunk)
    return out


def place(full: torch.Tensor, mesh, spec: tuple):
    """``full`` (the same on every rank) as a DTensor on the ``DeviceMesh``
    ``mesh`` by ``spec``: each rank keeps a copy of its own shard, and
    nothing is sent."""
    from torch.distributed.tensor import DTensor

    local = shard_of(full, mesh, spec).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False)


def _cuts(mesh, pl) -> list:
    """(mesh dim, tensor dim) of each placement that shards over more than
    one rank, the outer mesh dimension first."""
    return [(d, p.dim) for d, p in enumerate(pl)
            if p.is_shard() and mesh.size(d) > 1]


def _all_gather(x: torch.Tensor, mesh, pl, keep: tuple = ()) -> torch.Tensor:
    """The whole tensor of the shard ``x`` placed by ``pl`` on ``mesh``, by
    c10d ``all_gather`` over each sharding mesh dimension's group, the
    innermost first (``x`` itself where nothing is sharded); the mesh
    dimensions in ``keep`` stay cut. The functional collectives of
    ``DTensor.full_tensor`` end in a segmentation fault when gloo ranks
    hold CUDA tensors (torch 2.11 on the H100); c10d's do not."""
    import torch.distributed as dist

    for mdim, tdim in reversed(_cuts(mesh, pl)):
        if mdim in keep:
            continue
        parts = [torch.empty_like(x) for _ in range(mesh.size(mdim))]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(mdim))
        x = torch.cat(parts, dim=tdim)
    return x


def _narrow(x: torch.Tensor, mesh, cuts) -> torch.Tensor:
    """This rank's block of ``x`` along ``cuts`` (outer mesh dim first)."""
    coord = mesh.get_coordinate()
    for mdim, tdim in cuts:
        chunk = x.shape[tdim] // mesh.size(mdim)
        x = x.narrow(tdim, coord[mdim] * chunk, chunk)
    return x


def dp_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed in place over the data-parallel ranks of ``mesh`` (a
    ``DeviceMesh``): one c10d all-reduce a data-parallel dimension."""
    import torch.distributed as dist

    for d in data_parallel_dims(mesh):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(d))
    return x


class _Gather(torch.autograd.Function):
    """The parameter from this rank's shard, gathered over every mesh
    dimension but those in ``keep`` (a tensor-parallel part keeps its
    'model' shard), with a gradient to the shard.

    Backward turns the gathered parameter's gradient into this rank's
    shard gradient: cut along the gathered 'model' (non-data-parallel)
    shards, where the ranks took the same batch rows; summed over the
    data-parallel ranks, which took others; then cut along the
    data-parallel shards. The sum is an all-reduce before the cut (a
    reduce-scatter would send less)."""

    @staticmethod
    def forward(ctx, x, mesh, pl, keep):
        ctx.mesh, ctx.pl, ctx.keep = mesh, pl, keep
        out = _all_gather(x, mesh, pl, keep)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        cuts = [c for c in _cuts(mesh, ctx.pl) if c[0] not in ctx.keep]
        dp = data_parallel_dims(mesh)
        g = _narrow(g, mesh, [c for c in cuts if c[0] not in dp])
        if dp:
            g = dp_all_reduce(g.clone(memory_format=torch.contiguous_format),
                              mesh)
        g = _narrow(g, mesh, [c for c in cuts if c[0] in dp])
        return g.contiguous(), None, None, None


def gathered(dt, keep: tuple = ()) -> torch.Tensor:
    """The tensor of the DTensor ``dt`` on every rank, gathered over every
    mesh dimension but those in ``keep``. Where autograd records (grad
    mode on, ``dt`` requiring grad) its gradient reaches the shard
    (:class:`_Gather`); elsewhere, as under ``inference_mode``, no graph is
    built."""
    x = dt.to_local()
    if torch.is_grad_enabled() and dt.requires_grad:
        return _Gather.apply(x, dt.device_mesh, tuple(dt.placements), keep)
    return _all_gather(x, dt.device_mesh, dt.placements, keep)


def full_tensor(dt) -> torch.Tensor:
    """The whole tensor of an evenly sharded DTensor on every rank (no
    gradient), by c10d ``all_gather``."""
    return _all_gather(dt.to_local().detach(), dt.device_mesh, dt.placements)


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """The 'model' group of a ``DeviceMesh`` whose 'model' axis has more
    than one rank, else ``None``."""
    names = list(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names or mesh.size(names.index("model")) <= 1:
        return None
    d = names.index("model")
    return TensorParallel(mesh.get_group(d), mesh.size(d),
                          mesh.get_coordinate()[d])


def slot_group(mesh, tp: Optional[TensorParallel],
               g: int) -> Optional[TensorParallel]:
    """This rank's slot group of ``g`` consecutive 'model' ranks on the
    ``DeviceMesh`` ``mesh`` (``tp`` its 'model' group): the 'model' group
    itself where ``g`` is its size, else a c10d group of its own. Every
    rank creates every such group, in the same order (``new_group``).
    ``None`` where ``g`` is 1."""
    if tp is None or g <= 1:
        return None
    if g == tp.size:
        return tp
    import torch.distributed as dist

    d = list(mesh.mesh_dim_names).index("model")
    mine = None
    for ranks in mesh.mesh.movedim(d, -1).reshape(-1, tp.size).tolist():
        for first in range(0, tp.size, g):
            group = dist.new_group(ranks[first:first + g])
            if dist.get_rank() in ranks[first:first + g]:
                mine = group
    return TensorParallel(mine, g, dist.get_rank(mine))


def distribute_model(model: torch.nn.Module, mesh, specs: dict) -> None:
    """Place every parameter of the ``LanguageModel`` ``model`` (in place)
    as a DTensor on the ``DeviceMesh`` ``mesh`` by its spec in ``specs``
    (:func:`param_shardings`; one mesh axis a tensor dimension), and gather
    them around each forward, as GSPMD's FSDP all-gathers do: each unit
    (every entry of the model's module lists, i.e. every layer, and the
    model with the rest) replaces its parameters by their gathered tensors
    (:func:`gathered`) before its forward and puts the DTensors back after
    it. The gathered tensors carry their gradient to the shards.

    On a 'model' axis of more than one rank the parts that
    :func:`~repro_torch.distributed.tensor_parallel.split_plan` splits
    compute tensor-parallel: their parameters are gathered over the
    data-parallel axes only, each rank keeping its 'model' shard (its
    heads, FFN columns, experts, RG-LRU channels, RWKV-6 heads or vocab
    rows; a replicated KV head's ``wk`` and ``wv``, and the per-channel
    parameters of a split RG-LRU or RWKV-6: gathered whole, the rank's
    head or channels sliced out, the whole gradient summed over 'model'
    before it is cut; RWKV-6's mixes and ``w_lora_a``: gathered whole,
    their gradient summed over 'model'), and their modules (attention,
    MLA, RG-LRU, RWKV-6, MLP, MoE, the model for the vocab) learn the
    'model' group (their ``tp`` attribute). The other
    parameters are gathered whole, and the ranks along 'model' compute
    those blocks alike. Each attention layer whose slot group has more
    than one rank learns it (its ``slots``: :func:`slot_group`). The
    model learns the 'model' group as its ``sp`` too: a forward whose
    length divides it runs sequence-parallel, and there each rank
    differentiates the parameters it gathers whole, and a
    row-parallel projection's bias (which no spec cuts on 'model'), through
    its own positions, so their gradients are summed over 'model' too (the
    model's own final norm by the forward's batch; a layer's by the
    forward it runs in). An unsplit vocab's embedding and head are not:
    every rank looks up and projects every position, so each holds the
    whole gradient. Under ``remat`` a layer's
    recomputation in backward runs its hooks again, so its weights are
    gathered twice a step."""
    tp = tensor_parallel(mesh)
    cfg = model.cfg
    plan = split_plan(cfg, tp.size if tp is not None else 1)
    keep = tuple(d for d, n in enumerate(mesh.mesh_dim_names) if n == "model")
    model.sp = tp
    if tp is not None:
        for i in plan.attention + plan.mla + plan.rglru + plan.rwkv:
            model.blocks[i].inner.tp = tp
        for i in plan.mlp + tuple(i for i, _ in plan.moe):
            model.blocks[i].mlp.tp = tp
        if plan.vocab:
            model.tp = tp
    slots = slot_group(mesh, tp, plan.slot_group)
    for i in plan.slots:
        model.blocks[i].inner.slots = slots
    if plan.kv_replicated:  # the one KV head this rank's query heads use
        hd = cfg.head_dim
        head = tp.rank // (tp.size // cfg.num_kv_heads) * hd

    def use(param, mode, sp, on_model):
        if mode == "shard":  # a row-parallel bias (not cut on 'model') is
            # added on the rank's positions under sequence parallelism
            shard = gathered(param, keep)
            return shard if on_model else copy_to_tp(shard, sp)
        whole = gathered(param)
        if mode == "head":
            return copy_to_tp(whole, tp).narrow(-1, head, hd)
        if mode == "channels":  # the rank's channels of the last dim
            w = whole.shape[-1] // tp.size
            return copy_to_tp(whole, tp).narrow(-1, tp.rank * w, w)
        if mode == "summed":
            return copy_to_tp(whole, tp)
        if mode == "vocab":  # an unsplit vocab, on every position
            return whole
        return copy_to_tp(whole, sp)  # summed under sequence parallelism

    placed = {}
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        param = torch.nn.Parameter(place(p.detach(), mesh, specs[name]),
                                   requires_grad=p.requires_grad)
        mod._parameters[leaf] = param
        on_model = any(a == "model" or (isinstance(a, tuple) and "model" in a)
                       for a in specs[name])
        mode = plan.mode(name)
        if name in ("embed", "lm_head") and mode == "whole":
            mode = "vocab"
        placed[name] = (mod, leaf, param, mode, on_model)

    units = []  # (layer, its parameters' names)
    for prefix, child in model.named_children():
        if isinstance(child, torch.nn.ModuleList):
            for i, layer in enumerate(child):
                units.append((layer, [n for n in placed
                                      if n.startswith(f"{prefix}.{i}.")]))
    in_layers = {n for _, names in units for n in names}
    units.append((model, [n for n in placed if n not in in_layers]))

    def hooks(entries):
        def gather(module, args, kwargs):
            # a layer runs inside the model's forward; the model's own
            # parameters are gathered before it, for the forward's batch
            sp = (model.sequence_parallel_group(
                args[0] if args else kwargs["batch"])
                if module is model else sp_group())
            for mod, leaf, param, mode, on_model in entries:
                mod._parameters[leaf] = use(param, mode, sp, on_model)

        def reshard(module, args, out):
            for mod, leaf, param, *_ in entries:
                mod._parameters[leaf] = param

        return gather, reshard

    for unit, names in units:
        gather, reshard = hooks([placed[n] for n in names])
        unit.register_forward_pre_hook(gather, with_kwargs=True)
        unit.register_forward_hook(reshard)


def local_batch(mesh, batch: dict, microbatches: Optional[int] = None
                ) -> dict:
    """This rank's rows of a global batch, by :func:`batch_shardings` on
    the ``DeviceMesh`` ``mesh``.

    ``microbatches`` k (training; 1 without accumulation): the rank takes
    its shard of each of the k contiguous microbatches the global step
    cuts, so that its i-th microbatch is its part of the global i-th one;
    raises unless the batch divides k times the data-parallel ranks.
    ``None`` (serving): a batch that does not divide them rides whole on
    every rank (long_500k's batch of 1)."""
    dp = _dp_axes(mesh)
    n = axis_size(mesh, dp) if dp is not None else 1
    k = microbatches or 1
    specs = batch_shardings(mesh, batch)
    coord = coordinate(mesh)
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        if microbatches is not None and x.shape[0] % (k * n):
            raise ValueError(f"batch {key!r} of {x.shape[0]} rows does not "
                             f"divide {k} microbatches x {n} data-parallel "
                             "ranks")
        if n == 1 or specs[key][0] is None:
            out[key] = x
            continue
        rows = x.shape[0] // k
        out[key] = torch.cat([shard_of(x[i * rows:(i + 1) * rows], mesh,
                                       specs[key], coord) for i in range(k)])
    return out


def gather_batch(mesh, x: torch.Tensor, rows: int) -> torch.Tensor:
    """The global batch's ``rows`` of an output whose leading axis holds
    this rank's rows (:func:`local_batch`, serving): all-gathered over the
    data-parallel ranks (``x`` itself when it already holds them all)."""
    import torch.distributed as dist

    for d in reversed(data_parallel_dims(mesh)):
        if x.shape[0] == rows:
            break
        parts = [torch.empty_like(x) for _ in range(mesh.size(d))]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(d))
        x = torch.cat(parts)
    return x


# ------------------------------------------------- functions of a rank ----
def _placed_model(rank, cfg, mesh_shape: tuple, state: Optional[dict] = None):
    """``cfg``'s model on the rank's device (its own seeded initialization,
    or ``state``: numpy arrays by state-dict name), placed on a
    ``DeviceMesh`` of ``mesh_shape`` over ("data", "model"). Returns
    ``(mesh, model, specs)``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import LanguageModel

    dev = rank.device
    mesh = init_device_mesh(dev.type, tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    model = LanguageModel(cfg, device=dev)
    if state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               state.items()})
    specs = param_shardings(mesh, model)
    distribute_model(model, mesh, specs)
    return mesh, model, specs


def placed_forward(rank, cfg, mesh_shape: tuple, tokens) -> dict:
    """One rank of a forward with placed parameters, the function
    :func:`~repro_torch.launch.mesh.spawn_ranks` runs on every rank: the
    model of ``cfg`` (a ``ModelConfig``) from its own seeded
    initialization on the rank's device, placed by :func:`param_shardings`
    on a ``DeviceMesh`` of ``mesh_shape`` over ("data", "model") and run
    once on the rank's rows of ``tokens`` (B, S) (:func:`local_batch`).
    Returns the logits of
    the whole batch (numpy, f32; the ranks' rows gathered after the
    forward), each parameter's spec and its local shard shape, the shape
    of each projection's output as the rank computed it (``out_shapes``,
    by module name) and the shape of each layer's parameters as the rank
    computed with them (``used_shapes``, by name: its 'model' shard where
    its part splits, else whole) and the shape of each layer's input
    (``block_inputs``, a list: the rank's positions under sequence
    parallelism)."""
    from repro_torch.models import forward
    from repro_torch.models.layers import Dense

    mesh, model, specs = _placed_model(rank, cfg, mesh_shape)
    local = {name: tuple(p.to_local().shape)
             for name, p in model.named_parameters()}
    out_shapes, used_shapes = {}, {}
    block_inputs = _record_block_inputs(model)

    def record(name):
        def hook(module, args, y):
            out_shapes[name] = tuple(y.shape)
        return hook

    def record_used(name):  # inside the layer: the gathered tensors
        def hook(module, args, y):
            for leaf, p in module.named_parameters():
                used_shapes[f"{name}.{leaf}"] = tuple(p.shape)
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            mod.register_forward_hook(record(name))
        if name.startswith("blocks.") and name.count(".") == 2:
            mod.register_forward_hook(record_used(name))
    batch = local_batch(mesh, {"tokens": tokens})
    with torch.inference_mode():
        logits, _ = forward(model, batch)
        logits = gather_batch(mesh, logits, len(tokens))
    return {"logits": logits.float().cpu().numpy(), "specs": specs,
            "local_shapes": local, "out_shapes": out_shapes,
            "used_shapes": used_shapes, "block_inputs": block_inputs}


def _record_block_inputs(model) -> list:
    """A list that fills with the shape of each layer's input in its first
    forward (a forward pre-hook a layer)."""
    shapes = [None] * len(model.blocks)

    def record(i):
        def hook(module, args):
            if shapes[i] is None:
                shapes[i] = tuple(args[0].shape)
        return hook

    for i, block in enumerate(model.blocks):
        block.register_forward_pre_hook(record(i))
    return shapes


def placed_serve(rank, cfg, mesh_shape: tuple, tokens,
                 state: Optional[dict] = None, cache_len: Optional[int] = None,
                 more: tuple = (), keep_cache: bool = False) -> dict:
    """One rank of placed serving: the model of ``cfg`` (a
    ``ModelConfig``; a run may cut its depth) from its own seeded
    initialization (or ``state``: numpy arrays by state-dict name), placed
    as in :func:`placed_forward`, a prefill of the rank's rows of
    ``tokens`` (B, S) into a cache held for those rows alone, then one
    greedy decode step at slot S and one at each slot of ``more``, each
    fed the step before's token. The cache holds ``cache_len`` slots
    (default: S + 1 rounded up to a multiple of the 'model' axis, so that
    the slots split): the rank's KV heads where its GQA / MHA attention
    splits over 'model', the rank's block of the slots where the
    attention's slot group has more than one rank, and the rank's RG-LRU
    channels and RWKV-6 heads where those blocks split.
    Returns both steps' logits of the whole batch (numpy, f32; the ranks'
    rows gathered after each step; ``more``: a list), each step's
    collectives, host seconds (ended by a device synchronize) and peak
    device bytes (``None`` on the CPU), the bytes held on entry
    (:func:`_held_on_entry`), the cache's length, the shapes of its
    tensors (a dict a layer), the bytes of its attention layers' tensors
    (``attention_cache_bytes``) and, with ``keep_cache``, the tensors
    (numpy, floats at f32) and each layer's first slot (``cache_first``)
    at the end."""
    import time

    from repro_torch.launch.roofline import record_collectives
    from repro_torch.models import init_cache
    from repro_torch.models.attention import CacheBlock
    from repro_torch.train import make_decode_step, make_prefill_step

    dev = rank.device
    cuda = dev.type == "cuda"
    held = _held_on_entry(dev)  # an earlier run of the group's leftovers
    mesh, model, _ = _placed_model(rank, cfg, mesh_shape, state)
    prompt = local_batch(mesh, {"tokens": tokens})["tokens"].to(dev)
    B, S = prompt.shape
    tp = axis_size(mesh, "model")
    cache_len = cache_len or -(-(S + 1) // tp) * tp
    cache = init_cache(cfg, B, cache_len, dev, tp=tp,
                       rank=coordinate(mesh)["model"])
    out = {"collectives": {}, "step_s": {}, "peak_device_bytes": {},
           "held_on_entry": held, "cache_len": cache_len,
           "cache_shapes": [{k: tuple(v.shape) for k, v in layer.items()}
                            for layer in cache],
           "attention_cache_bytes": sum(
               v.numel() * v.element_size()
               for layer, kind in zip(cache, cfg.layer_kinds)
               if kind == "attn" for v in layer.values())}

    def timed(key, fn, *args):
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with record_collectives() as coll:
            res = fn(*args)
        if cuda:
            torch.cuda.synchronize(dev)
        out["step_s"][key] = time.perf_counter() - t0
        out["peak_device_bytes"][key] = (
            torch.cuda.max_memory_allocated(dev) if cuda else None)
        out["collectives"][key] = coll
        return res

    logits, cache = timed("prefill", make_prefill_step(model),
                          {"tokens": prompt}, cache)
    decode = make_decode_step(model)
    steps = [logits]
    for i, index in enumerate((S,) + tuple(more)):
        tok = steps[-1].argmax(-1)[:, None].to(torch.int32)
        step, cache = timed("decode" if i == 0 else ("more", i - 1), decode,
                            tok, cache, index)
        steps.append(step)
    with torch.inference_mode():
        steps = [gather_batch(mesh, x, len(tokens)).float().cpu().numpy()
                 for x in steps]
    out["prefill"], out["decode"], out["more"] = steps[0], steps[1], steps[2:]
    for key in ("collectives", "step_s", "peak_device_bytes"):
        out[key]["more"] = [out[key].pop(("more", i))
                            for i in range(len(more))]
    if keep_cache:
        out["cache"] = [{k: (v.float() if v.is_floating_point() else v)
                         .cpu().numpy() for k, v in layer.items()}
                        for layer in cache]
        out["cache_first"] = [layer.first if isinstance(layer, CacheBlock)
                              else 0 for layer in cache]
    return out


def _held_on_entry(dev) -> Optional[int]:
    """The device bytes still allocated when a run of a group starts, after
    the garbage of the earlier runs is collected and the cached blocks
    freed (``None`` on the CPU): the floor under the run's peaks."""
    if dev.type != "cuda":
        return None
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in f64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def placed_train_step(rank, cfg, mesh_shape: tuple, batches: list, tcfg,
                      state: Optional[dict] = None, check: bool = True,
                      keep: bool = False) -> dict:
    """One rank of placed training: the model of ``cfg`` (a
    ``ModelConfig``) placed as in :func:`placed_forward` (from ``state``,
    numpy arrays by state-dict name, if given), AdamW moments placed as
    the parameters, and one step of ``make_train_step(cfg, tcfg, mesh)``
    on the rank's rows (:func:`local_batch`) of each global batch of
    ``batches`` (dicts of CPU tensors or arrays).

    Returns each step's metrics (floats), collectives
    (:func:`~repro_torch.launch.roofline.record_collectives`), host
    seconds (ended by a device synchronize) and peak device bytes (CUDA;
    ``None`` on the CPU), the bytes held on entry (:func:`_held_on_entry`),
    the shape of each layer's input in the first forward
    (``block_inputs``), the rank's coordinate, the specs and the host
    seconds of the set-up, the one-process run and the gradient checks. With
    ``check``: first one process's steps on the whole batches from the
    same weights (``make_train_step`` without a mesh; the rank's slices of
    its gradients and parameters kept on the host), then ``distances``:
    the worst relative distance of the metrics, of the final parameters
    (max over elements over the largest, the worst tensor) and of every
    step's gradients (relative L2, the worst tensor), each shard against
    its slice of the one-process tensor, compared in f64 on the rank's
    device after each step's clock and peak are read. With ``keep`` also
    the final local shards (``params``, numpy)."""
    import dataclasses
    import time

    from repro_torch.launch.roofline import record_collectives
    from repro_torch.models import LanguageModel
    from repro_torch.train import adamw_init, make_train_step

    dev = rank.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    held_on_entry = _held_on_entry(dev)
    t0 = time.perf_counter()
    mesh, model, specs = _placed_model(rank, cfg, mesh_shape, state)
    block_inputs = _record_block_inputs(model)
    sync()
    setup_s = time.perf_counter() - t0
    want = {"grads": [], "metrics": []}
    if check:
        ref = LanguageModel(cfg, device=dev)
        if state is not None:
            ref.load_state_dict({k: torch.as_tensor(v) for k, v in
                                 state.items()})

        def keep_ref(grads):
            want["grads"].append({n: shard_of(g.detach(), mesh,
                                              specs[n]).cpu()
                                  for n, g in grads.items()})
            return grads

        step = make_train_step(cfg, dataclasses.replace(
            tcfg, grad_transform=keep_ref))
        opt = adamw_init(dict(ref.named_parameters()), tcfg.optimizer)
        for batch in batches:
            ref, opt, m = step(ref, opt, {k: torch.as_tensor(v)
                                          for k, v in batch.items()})
            want["metrics"].append({k: float(v) for k, v in m.items()})
        want["params"] = {n: shard_of(p.detach(), mesh, specs[n]).cpu()
                          for n, p in ref.named_parameters()}
        del ref, opt, step
        if cuda:
            torch.cuda.empty_cache()
    reference_s = time.perf_counter() - t0 - setup_s

    held = []  # this step's gradients, compared after the step
    step = make_train_step(cfg, dataclasses.replace(
        tcfg, grad_transform=lambda g: held.append(g) or g), mesh=mesh)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    metrics, colls, times, peaks, grad_dist = [], [], [], [], []
    check_s = 0.0
    for i, batch in enumerate(batches):
        local = local_batch(mesh, batch, tcfg.grad_accum)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with record_collectives() as coll:
            model, opt, m = step(model, opt, local)
        sync()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev) if cuda else None)
        metrics.append({k: float(v) for k, v in m.items()})
        colls.append(coll)
        grads = held.pop()
        t1 = time.perf_counter()
        if check:
            grad_dist.append(max(
                (_rel_l2(local_tensor(g).detach(),
                         want["grads"][i][n].to(dev)), n)
                for n, g in grads.items()))
        del grads
        check_s += time.perf_counter() - t1
    out = {"metrics": metrics, "collectives": colls, "step_s": times,
           "peak_device_bytes": peaks, "held_on_entry": held_on_entry,
           "block_inputs": block_inputs,
           "coords": coordinate(mesh),
           "specs": specs, "setup_s": setup_s, "reference_s": reference_s,
           "check_s": check_s}
    if keep:
        out["params"] = {n: local_tensor(p).detach().cpu().numpy()
                         for n, p in model.named_parameters()}
    if check:
        worst_metric = max(
            (abs(a[k] - b[k]) / max(abs(b[k]), 1e-30), f"{k} step {i}")
            for i, (a, b) in enumerate(zip(metrics, want["metrics"]))
            for k in a if k in b)
        worst_param = max((_rel(local_tensor(p).detach(),
                                want["params"][n].to(dev)), n)
                          for n, p in model.named_parameters())
        out["distances"] = {"metrics": worst_metric, "params": worst_param,
                            "grads": max(grad_dist)}
    return out
