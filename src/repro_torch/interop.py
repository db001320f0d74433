"""Carry a decomposition, a packed factor or a plan from the JAX reference
into the port, at a chosen dtype.

:func:`from_reference_problem` builds the port's :class:`FetiProblem` from
the reference's host arrays, so both packages can be fed the identical
decomposition; :func:`from_reference_packed` builds a
:class:`PackedBlocks` from a packed factor's values and block layout;
:func:`schur_config_from_reference` and :func:`plan_from_reference` map an
assembly config's fields and a plan's JSON (``use_pallas`` becomes
``use_kernels``; ``interpret`` has no counterpart). All take plain numpy
arrays or dicts (never the reference's objects) and import nothing of the
reference. A problem's host arrays are f64 (the pipeline rounds them
to its storage dtype itself); a packed factor is carried at ``dtype``, so
both packages' f32 factors can be compared on identical values.

For the LM path, :func:`lm_params_from_reference` turns the reference's
params pytree (as numpy) into a :class:`~repro_torch.models.LanguageModel`
state dict, :func:`lm_layers_from_reference` unstacks any per-layer tree
of the reference (params or caches) into layer order, and
:func:`random_lm_state` draws seeded numpy weights for every parameter of
a config, so that both packages (or a run without the reference) can be
fed the identical weights. :func:`train_state_from_reference` carries a
training state (params and AdamW moments) the same way, so both packages
can go on from the same point mid-training.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autotune import Plan
from repro_torch.core.schur import SchurAssemblyConfig
from repro_torch.fem.decomposition import FetiProblem, SubdomainData
from repro_torch.fem.meshgen import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES
from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import StackLayout
from repro_torch.sparse.packed import PackedBlockIndex, PackedBlocks

__all__ = ["SUBDOMAIN_KEYS", "from_reference_problem", "from_reference_packed",
           "schur_config_from_reference", "plan_from_reference",
           "lm_layers_from_reference", "lm_params_from_reference",
           "train_state_from_reference", "random_lm_state"]

SUBDOMAIN_KEYS = ("K", "Bt", "f", "R", "lambda_ids", "m", "dof_gids",
                  "fixing_dofs", "b_rows", "b_vals")


def from_reference_problem(arrays: dict) -> FetiProblem:
    """Port-side ``FetiProblem`` from a dict of host arrays.

    ``arrays`` holds ``subdomains`` — a list of dicts with the keys of
    :data:`SUBDOMAIN_KEYS` (``node_gids``/``fixing_node`` optional; heat
    has node ids = DOF ids and the fixing node = the fixing DOF; an
    elasticity decomposition must carry both) — and ``c``, ``n_lambda``,
    ``dirichlet_gids``, ``coords``, ``elems``, ``dim``, ``sub_grid``,
    ``elems_per_sub`` and optionally ``params``, ``problem`` (default
    ``"heat"``) and ``ndof_per_node`` (default 1). The kernel dimension is
    the width of ``R``.
    """
    problem = arrays.get("problem", "heat")
    ndpn = int(arrays.get("ndof_per_node", 1))
    if ndpn > 1 and any("node_gids" not in sd or "fixing_node" not in sd
                        for sd in arrays["subdomains"]):
        raise KeyError("a vector decomposition needs node_gids and "
                       "fixing_node for every subdomain")
    subs = []
    for i, sd in enumerate(arrays["subdomains"]):
        missing = [k for k in SUBDOMAIN_KEYS if k not in sd]
        if missing:
            raise KeyError(f"subdomain {i} lacks {missing}")
        fixing = np.asarray(sd["fixing_dofs"], dtype=np.int64)
        dof_gids = np.asarray(sd["dof_gids"], dtype=np.int64)
        subs.append(SubdomainData(
            index=i,
            K=np.asarray(sd["K"], dtype=np.float64),
            f=np.asarray(sd["f"], dtype=np.float64),
            Bt=np.asarray(sd["Bt"], dtype=np.float64),
            lambda_ids=np.asarray(sd["lambda_ids"], dtype=np.int64),
            m=int(sd["m"]),
            node_gids=np.asarray(sd.get("node_gids", dof_gids), dtype=np.int64),
            dof_gids=dof_gids,
            fixing_node=int(sd.get("fixing_node", fixing[0])),
            R=np.asarray(sd["R"], dtype=np.float64),
            fixing_dofs=fixing,
            b_rows=np.asarray(sd["b_rows"], dtype=np.int64),
            b_vals=np.asarray(sd["b_vals"], dtype=np.float64),
        ))
    coords = np.asarray(arrays["coords"], dtype=np.float64)
    return FetiProblem(
        dim=int(arrays["dim"]),
        sub_grid=tuple(arrays["sub_grid"]),
        elems_per_sub=tuple(arrays["elems_per_sub"]),
        n_lambda=int(arrays["n_lambda"]),
        subdomains=subs,
        c=np.asarray(arrays["c"], dtype=np.float64),
        global_mesh=Mesh(dim=coords.shape[1], coords=coords,
                         elems=np.asarray(arrays["elems"], dtype=np.int64)),
        dirichlet_gids=np.asarray(arrays["dirichlet_gids"], dtype=np.int64),
        problem=problem,
        ndof_per_node=ndpn,
        kernel_dim=subs[0].R.shape[1],
        params=dict(arrays.get("params", {})),
    )


def from_reference_packed(values: np.ndarray, mask: np.ndarray, n: int,
                          bs: int, dtype: torch.dtype = torch.float64
                          ) -> PackedBlocks:
    """Port-side :class:`PackedBlocks` from a packed factor's host arrays.

    ``values`` is the (..., n_blocks, bs, bs) value stack (the reference's
    ``PackedBlocks.values`` as numpy), ``mask`` its (nb, nb) block mask
    (the reference index's ``mask``), ``n`` and ``bs`` its size and block
    size. The index is rebuilt from the mask, so its slot order is the
    reference's: (row, col)-sorted, diagonal last in each row. The values
    land on the CPU at ``dtype`` (an f32 stack carried at f32 is exact).
    """
    index = PackedBlockIndex.from_mask(mask, n, bs)
    vals = torch.as_tensor(np.array(values, dtype=np.float64)).to(dtype)
    index.validate(vals)
    return PackedBlocks(vals, index)


def schur_config_from_reference(fields: dict) -> SchurAssemblyConfig:
    """The port's config from a reference config's fields (its
    ``dataclasses.asdict``): ``use_pallas`` becomes ``use_kernels``,
    ``interpret`` (the Pallas interpreter) is dropped."""
    d = dict(fields)
    d["use_kernels"] = d.pop("use_pallas")
    d.pop("interpret", None)
    return SchurAssemblyConfig(**d)


def plan_from_reference(d: dict) -> Plan:
    """The port's :class:`Plan` from a reference plan's ``to_json()``."""
    d = dict(d)
    d["cfg"] = schur_config_from_reference(d["cfg"])
    return Plan(**d)


# ------------------------------------------------------------- LM path ----
def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor, bit for bit. numpy has no bf16 or
    float8: the reference's come as ``ml_dtypes`` arrays, which
    ``torch.from_numpy`` refuses, so they travel as an unsigned view."""
    a = np.asarray(a)
    name = a.dtype.name
    if name in DTYPES and not hasattr(np, name):
        bits = {1: np.uint8, 2: np.uint16}[a.dtype.itemsize]
        return torch.from_numpy(np.array(a).view(bits)).view(DTYPES[name])
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def lm_layers_from_reference(cfg: ModelConfig, stack: dict) -> list:
    """The reference's ``{"prologue", "body", "epilogue"}`` tree (a params
    ``stack`` or a cache) as one nested dict per layer, in layer order:
    ``body[j]``'s leaves are stacked over cycles, cycle ``c`` being layer
    ``StackLayout.layer(j, c)``."""
    lay = StackLayout.build(cfg)
    layers = [None] * cfg.num_layers
    for i, li in enumerate(lay.prologue):
        layers[li] = stack["prologue"][i]
    for i, li in enumerate(lay.epilogue):
        layers[li] = stack["epilogue"][i]

    def cut(tree, c):
        return {k: cut(v, c) if isinstance(v, dict) else np.asarray(v)[c]
                for k, v in tree.items()}

    for j, body in enumerate(stack["body"]):
        for c in range(lay.cycles if body is not None else 0):
            layers[lay.layer(j, c)] = cut(body, c)
    missing = [li for li, t in enumerate(layers) if t is None]
    if missing:
        raise KeyError(f"layers {missing} are missing from the tree")
    return layers


def lm_params_from_reference(cfg: ModelConfig, params: dict) -> dict:
    """The state dict of ``LanguageModel(cfg)`` (CPU tensors at the
    reference's dtypes) from the reference's params pytree, its leaves as
    numpy. Load with ``model.load_state_dict(state)``. A MoE layer's
    stacked experts (E, ...) are leaves like any other: stacked over the
    cycles in ``body``, cut per cycle."""
    state = {"embed": _tensor(params["embed"])}
    for i, block in enumerate(lm_layers_from_reference(cfg,
                                                       params["stack"])):
        for path, leaf in _flatten(block):
            state[f"blocks.{i}.{path}"] = _tensor(leaf)
    for path, leaf in _flatten(params["final_norm"]):
        state[f"final_norm.{path}"] = _tensor(leaf)
    if "lm_head" in params:
        state["lm_head"] = _tensor(params["lm_head"])
    return state


def train_state_from_reference(cfg: ModelConfig, params: dict,
                               opt_state: dict) -> tuple:
    """``(state_dict, {"m", "v", "step"})`` of the port's training step from
    the reference's params pytree and AdamW state (numpy leaves): the
    moments are trees shaped like the params, so they map to the same
    names, at their own dtype; ``step`` is an int32 0-dim tensor."""
    return (lm_params_from_reference(cfg, params),
            {"m": lm_params_from_reference(cfg, opt_state["m"]),
             "v": lm_params_from_reference(cfg, opt_state["v"]),
             "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                  dtype=torch.int32)})


def random_lm_state(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded f32 numpy values for every parameter of ``LanguageModel(cfg)``,
    by state-dict name (round them to ``cfg.param_dtype`` to load).

    Unlike the model's own initialization, every weight is drawn: norm
    scales (MLA's ``q_norm_scale`` and ``kv_norm_scale`` too) around 1,
    biases and the RWKV bonus around 0, mixes in (0, 1), RWKV decay offsets
    near -3, RG-LRU's Λ with a = σ(Λ) in (0.9, 0.999), dense weights and
    the MoE router N(0, 1/d_in), the stacked experts (E, d_in, d_out)
    N(0, 1/d_in), the embedding N(0, 1) (distinct logits)."""
    meta = LanguageModel(cfg, device="meta").state_dict()
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in meta.items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if leaf in ("scale", "q_norm_scale", "kv_norm_scale"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf in ("b", "bias", "conv_b", "u"):
            v = 0.1 * rng.standard_normal(shape)
        elif leaf in ("w", "lm_head", "router"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif leaf in ("wi", "wg", "wo") and len(shape) == 3:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif leaf == "embed":
            v = rng.standard_normal(shape)
        elif leaf == "conv_w":
            v = 0.3 * rng.standard_normal(shape)
        elif leaf.startswith("mix_") or leaf == "cm_mix":
            v = rng.uniform(0.0, 1.0, shape)
        elif leaf == "w0":
            v = -3.0 + 0.3 * rng.standard_normal(shape)
        elif leaf == "lam":
            p = rng.uniform(0.9, 0.999, shape)
            v = np.log(p / (1 - p))
        else:
            raise KeyError(f"no draw for parameter {name!r}")
        out[name] = v.astype(np.float32)
    return out
