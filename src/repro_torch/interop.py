"""Carry a decomposition from the JAX reference into the port.

:func:`from_reference_problem` builds the port's :class:`FetiProblem` from
the reference's host arrays, so both packages can be fed the identical
decomposition. It takes plain numpy arrays (never the reference's objects)
and imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fem.decomposition import FetiProblem, SubdomainData
from repro_torch.fem.meshgen import Mesh

__all__ = ["SUBDOMAIN_KEYS", "from_reference_problem"]

SUBDOMAIN_KEYS = ("K", "Bt", "f", "R", "lambda_ids", "m", "dof_gids",
                  "fixing_dofs", "b_rows", "b_vals")


def from_reference_problem(arrays: dict) -> FetiProblem:
    """Port-side ``FetiProblem`` from a dict of host arrays.

    ``arrays`` holds ``subdomains`` — a list of dicts with the keys of
    :data:`SUBDOMAIN_KEYS` (``node_gids``/``fixing_node`` optional; heat
    has node ids = DOF ids and the fixing node = the fixing DOF) — and
    ``c``, ``n_lambda``, ``dirichlet_gids``, ``coords``, ``elems``, ``dim``,
    ``sub_grid``, ``elems_per_sub`` and optionally ``params``.
    """
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
        params=dict(arrays.get("params", {})),
    )
