"""Total-FETI domain decomposition of the structured heat-transfer problem
(counterpart of ``repro.fem.decomposition``, heat only).

Decomposes a structured box into a grid of equally-sized box subdomains
(paper Fig. 2), duplicates interface nodes, and builds:

  * per-subdomain stiffness ``K_i`` (SPSD, kernel = constants, k = 1) and
    load ``f_i``,
  * the signed boolean gluing matrix ``B`` as per-subdomain dense blocks
    ``B̃ᵢᵀ`` (n_i × m_i) plus global multiplier ids (non-redundant chain
    gluing between node copies),
  * Dirichlet conditions on the x=0 face enforced as constraints (total
    FETI: every subdomain stays floating, kernels are uniform),
  * the orthonormal kernel basis ``R_i`` (n_i × 1) and the fixing DOF of
    the analytic regularization.

Everything here is host-side numpy; the solver moves the stacks to the
device. Vector elasticity is ROADMAP item A10.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List

import numpy as np

from repro_torch.fem.assembly import (
    assemble_dense,
    assemble_scipy_csr,
    load_vector,
    p1_element_stiffness,
)
from repro_torch.fem.meshgen import Mesh, structured_mesh
from repro_torch.fem.regularization import kernel_basis

__all__ = ["SubdomainData", "FetiProblem", "decompose_problem"]


@dataclasses.dataclass
class SubdomainData:
    """One subdomain's local system and gluing.

    Every local multiplier column of B̃ᵀ has exactly ONE ±1 entry (chain
    gluing / Dirichlet pinning), recorded compactly in (b_rows, b_vals);
    the dense Bt is derived from them.
    """

    index: int
    K: np.ndarray  # (n_i, n_i) dense SPSD stiffness
    f: np.ndarray  # (n_i,) load
    Bt: np.ndarray  # (n_i, m_max) dense ±1, zero-padded columns
    lambda_ids: np.ndarray  # (m_max,) global multiplier ids; pad = n_lambda
    m: int  # actual number of local multipliers
    node_gids: np.ndarray  # (n_nodes_i,) global node ids
    dof_gids: np.ndarray  # (n_i,) global DOF ids (= node_gids for heat)
    fixing_node: int  # local node id anchoring the regularization
    R: np.ndarray = None  # (n_i, 1) orthonormal kernel basis
    fixing_dofs: np.ndarray = None  # (1,) local DOFs; R[fixing_dofs] invertible
    b_rows: np.ndarray = None  # (m_max,) local row of each column's ±1
    b_vals: np.ndarray = None  # (m_max,) the ±1 values

    @property
    def n(self) -> int:
        return len(self.dof_gids)


@dataclasses.dataclass
class FetiProblem:
    """The decomposed problem + everything needed for validation."""

    dim: int
    sub_grid: tuple
    elems_per_sub: tuple
    n_lambda: int
    subdomains: List[SubdomainData]
    c: np.ndarray  # (n_lambda,) constraint rhs (Dirichlet values; zeros here)
    global_mesh: Mesh
    dirichlet_gids: np.ndarray  # global NODE ids on the x=0 face
    problem: str = "heat"
    ndof_per_node: int = 1
    kernel_dim: int = 1
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def n_subdomains(self) -> int:
        return len(self.subdomains)

    @property
    def m_max(self) -> int:
        return self.subdomains[0].Bt.shape[1]

    @property
    def n_global_dofs(self) -> int:
        return self.global_mesh.n_nodes * self.ndof_per_node

    @property
    def dirichlet_dofs(self) -> np.ndarray:
        """Global DOF ids pinned by the Dirichlet face."""
        return self.dirichlet_gids

    def reference_solution(self) -> np.ndarray:
        """Direct sparse solve of the undecomposed global system with the
        Dirichlet condition (the validation oracle). Returns the
        (n_global_dofs,) solution."""
        import scipy.sparse.linalg as spla

        mesh = self.global_mesh
        Ke = p1_element_stiffness(mesh.coords, mesh.elems,
                                  kappa=self.params.get("kappa", 1.0))
        f = load_vector(mesh.coords, mesh.elems, mesh.n_nodes,
                        source=self.params.get("source", 1.0))
        nd = self.n_global_dofs
        K = assemble_scipy_csr(nd, mesh.elems, Ke)
        free = np.setdiff1d(np.arange(nd), self.dirichlet_dofs)
        u = np.zeros(nd)
        u[free] = spla.spsolve(K[free][:, free].tocsc(), f[free])
        return u


def decompose_problem(
    problem: str,
    dim: int,
    sub_grid: tuple,
    elems_per_sub: tuple,
    kappa: float = 1.0,
    source: float = 1.0,
) -> FetiProblem:
    """Build the total-FETI decomposition of the structured heat problem.

    Args:
      problem: "heat" (scalar P1, k=1); "elasticity" is ROADMAP item A10.
      dim: 2 or 3.
      sub_grid: number of subdomains per axis, e.g. (4, 4).
      elems_per_sub: elements per axis per subdomain, e.g. (8, 8).
      kappa/source: conductivity and source term.
    """
    if problem == "elasticity":
        raise NotImplementedError("elasticity is ROADMAP item A10")
    if problem != "heat":
        raise ValueError(f"unknown problem {problem!r}")
    if dim != len(sub_grid) or dim != len(elems_per_sub):
        raise ValueError("dim / sub_grid / elems_per_sub mismatch")
    gshape = tuple(sub_grid[d] * elems_per_sub[d] for d in range(dim))
    gmesh = structured_mesh(gshape)
    gnode_shape = tuple(g + 1 for g in gshape)
    gstrides = [1]
    for d in range(dim - 1):
        gstrides.append(gstrides[-1] * gnode_shape[d])

    spacing = tuple(1.0 / gshape[d] for d in range(dim))
    sub_lengths = tuple(elems_per_sub[d] * spacing[d] for d in range(dim))
    sub_list = list(itertools.product(*[range(sub_grid[d]) for d in range(dim)]))
    n_subs = len(sub_list)

    # --- per-subdomain meshes, K_i, f_i ---
    lshape = tuple(elems_per_sub[d] + 1 for d in range(dim))  # nodes per axis
    lstrides = [1]
    for d in range(dim - 1):
        lstrides.append(lstrides[-1] * lshape[d])
    lranges = [np.arange(lshape[d]) for d in range(dim)]
    lgrid = np.meshgrid(*lranges, indexing="ij")
    lidx = np.stack([g.ravel(order="F") for g in lgrid], axis=1)  # (n_i, dim)
    n_local = int(np.prod(lshape))

    Ks, fs, gids_per_sub = [], [], []
    for s in sub_list:
        origin = tuple(s[d] * sub_lengths[d] for d in range(dim))
        lmesh = structured_mesh(elems_per_sub, origin=origin,
                                lengths=sub_lengths)
        Ke = p1_element_stiffness(lmesh.coords, lmesh.elems, kappa=kappa)
        Ks.append(assemble_dense(n_local, lmesh.elems, Ke))
        fs.append(load_vector(lmesh.coords, lmesh.elems, lmesh.n_nodes,
                              source=source))
        gnode = lidx + np.array([s[d] * elems_per_sub[d] for d in range(dim)])
        gids_per_sub.append((gnode * np.array(gstrides)).sum(axis=1)
                            .astype(np.int64))

    R_shared = kernel_basis(n_local, "heat")

    # --- ownership: global node -> [(sub, local_id)] ---
    owners: dict[int, list[tuple[int, int]]] = {}
    for si, gids in enumerate(gids_per_sub):
        for lid, g in enumerate(gids):
            owners.setdefault(int(g), []).append((si, lid))

    # --- multipliers: chain gluing over the (sub-sorted) copies of each
    # shared node; the Dirichlet x=0 face pins every copy instead ---
    triplets: list[list[tuple[int, int, float]]] = [[] for _ in range(n_subs)]
    n_lambda = 0
    dirichlet_gids = []
    for g in sorted(owners):
        copies = owners[g]
        if g % gnode_shape[0] == 0:
            dirichlet_gids.append(g)
            for (sa, la) in copies:
                triplets[sa].append((la, n_lambda, 1.0))
                n_lambda += 1
        else:
            for (sa, la), (sb, lb) in zip(copies, copies[1:]):
                triplets[sa].append((la, n_lambda, 1.0))
                triplets[sb].append((lb, n_lambda, -1.0))
                n_lambda += 1

    m_per_sub = [len(t) for t in triplets]
    m_max = max(m_per_sub)

    # --- fixing node: subdomain center (paper's analytic regularization) ---
    center = tuple(lshape[d] // 2 for d in range(dim))
    fixing_local = int(sum(center[d] * lstrides[d] for d in range(dim)))
    fix_dofs = np.asarray([fixing_local], dtype=np.int64)

    subdomains = []
    for si in range(n_subs):
        lam_ids = np.full((m_max,), n_lambda, dtype=np.int64)  # pad -> dummy
        b_rows = np.zeros((m_max,), dtype=np.int64)
        b_vals = np.zeros((m_max,), dtype=np.float64)
        for col, (lid, gl, val) in enumerate(triplets[si]):
            lam_ids[col] = gl
            b_rows[col] = lid
            b_vals[col] = val
        m = m_per_sub[si]
        Bt = np.zeros((n_local, m_max), dtype=np.float64)
        Bt[b_rows[:m], np.arange(m)] = b_vals[:m]
        gids = gids_per_sub[si]
        subdomains.append(SubdomainData(
            index=si, K=Ks[si], f=fs[si], Bt=Bt, lambda_ids=lam_ids, m=m,
            node_gids=gids, dof_gids=gids, fixing_node=fixing_local,
            R=R_shared, fixing_dofs=fix_dofs, b_rows=b_rows, b_vals=b_vals,
        ))

    return FetiProblem(
        dim=dim,
        sub_grid=tuple(sub_grid),
        elems_per_sub=tuple(elems_per_sub),
        n_lambda=n_lambda,
        subdomains=subdomains,
        c=np.zeros((n_lambda,), dtype=np.float64),
        global_mesh=gmesh,
        dirichlet_gids=np.asarray(sorted(set(dirichlet_gids)), dtype=np.int64),
        params=dict(kappa=kappa, source=source),
    )
