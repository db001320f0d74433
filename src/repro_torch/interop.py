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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autotune import Plan
from repro_torch.core.schur import SchurAssemblyConfig
from repro_torch.fem.decomposition import FetiProblem, SubdomainData
from repro_torch.fem.meshgen import Mesh
from repro_torch.sparse.packed import PackedBlockIndex, PackedBlocks

__all__ = ["SUBDOMAIN_KEYS", "from_reference_problem", "from_reference_packed",
           "schur_config_from_reference", "plan_from_reference"]

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
