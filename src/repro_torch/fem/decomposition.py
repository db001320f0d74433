"""Total-FETI domain decomposition of structured heat-transfer and
linear-elasticity problems (counterpart of ``repro.fem.decomposition``).

Decomposes a structured box into a grid of equally-sized box subdomains
(paper Fig. 2), duplicates interface nodes, and builds:

  * per-subdomain stiffness ``K_i`` (SPSD) and load ``f_i``: scalar P1
    heat (kernel = constants, k = 1) or node-blocked vector P1 linear
    elasticity (kernel = rigid-body modes, k = 3 in 2D / 6 in 3D),
  * the signed boolean gluing matrix ``B`` as per-subdomain dense blocks
    ``B̃ᵢᵀ`` (n_i × m_i) plus global multiplier ids (non-redundant chain
    gluing between DOF copies; vector problems glue every component),
  * Dirichlet conditions on the x=0 face enforced as constraints (total
    FETI: every subdomain stays floating, kernels are uniform),
  * the orthonormal kernel basis ``R_i`` (n_i × k) and the k fixing DOFs
    of the analytic regularization.

All subdomains share one local topology and one kernel basis: the local
template's rigid-body modes span every translated copy's kernel.
Everything here is host-side numpy; the solver moves the stacks to the
device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List

import numpy as np

from repro_torch.fem.assembly import (
    assemble_dense,
    assemble_scipy_csr,
    elasticity_load_vector,
    element_dofs,
    load_vector,
    p1_elasticity_stiffness,
    p1_element_stiffness,
)
from repro_torch.fem.meshgen import Mesh, structured_mesh
from repro_torch.fem.regularization import kernel_basis

__all__ = ["SubdomainData", "FetiProblem", "decompose_problem",
           "decompose_elasticity_problem", "DEFAULT_BODY_FORCE"]

DEFAULT_BODY_FORCE = {2: (0.0, -1.0), 3: (0.0, 0.0, -1.0)}


@dataclasses.dataclass
class SubdomainData:
    """One subdomain's local system and gluing.

    Every local multiplier column of B̃ᵀ has exactly ONE ±1 entry (chain
    gluing / Dirichlet pinning), recorded compactly in (b_rows, b_vals);
    the dense Bt is derived from them. Rows of K / f / Bt / R are DOFs in
    node-blocked order (DOF = node*ndpn + component; ndpn = 1 for heat).
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
    R: np.ndarray = None  # (n_i, k) orthonormal kernel basis
    fixing_dofs: np.ndarray = None  # (k,) local DOFs; R[fixing_dofs] invertible
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
        """Global DOF ids pinned by the Dirichlet face (all components)."""
        ndpn = self.ndof_per_node
        return (self.dirichlet_gids[:, None] * ndpn
                + np.arange(ndpn)).reshape(-1)

    # ---- multi-RHS load cases (solver inputs) ----
    def load_stack(self) -> np.ndarray:
        """The problem's own per-subdomain loads as one (S, n) stack."""
        return np.stack([sd.f for sd in self.subdomains])

    def load_cases(self, n_rhs: int, kind: str = "sweep",
                   seed: int = 0) -> np.ndarray:
        """(n_rhs, S, n) stacked load cases for the multi-RHS solve.

        ``kind="sweep"`` scales the assembled body load by 1, 2, … (the
        solutions are the scaled base solution); ``kind="random"`` draws
        i.i.d. normal per-DOF loads scaled to the base load's magnitude;
        ``kind="mixed"`` keeps the base load as column 0, a zero load
        (converged at iteration 0) as column 1 and random columns after.
        Every case is a legal FETI load: the global problem's right-hand
        side is :meth:`global_load` of it. The same cases as the
        reference's for the same ``seed`` (numpy's generator).
        """
        base = self.load_stack()
        if kind == "sweep":
            scales = 1.0 + np.arange(n_rhs, dtype=float)
            return scales[:, None, None] * base[None]
        rng = np.random.default_rng(seed)
        norm = np.abs(base).max()
        rand = rng.standard_normal((n_rhs,) + base.shape) * norm
        if kind == "random":
            return rand
        if kind == "mixed":
            cases = rand
            cases[0] = base
            if n_rhs > 1:
                cases[1] = 0.0
            return cases
        raise ValueError(f"unknown load-case kind {kind!r}")

    def global_load(self, loads: np.ndarray) -> np.ndarray:
        """Assemble one (S, n) per-subdomain load stack into the
        (n_global_dofs,) global right-hand side: interface DOFs sum their
        subdomain copies."""
        f = np.zeros(self.n_global_dofs)
        for i, sd in enumerate(self.subdomains):
            np.add.at(f, sd.dof_gids, loads[i])
        return f

    def _global_system(self):
        """Assembled global (K csr, f, free-DOF ids) with Dirichlet BC."""
        mesh = self.global_mesh
        if self.problem == "heat":
            Ke = p1_element_stiffness(mesh.coords, mesh.elems,
                                      kappa=self.params.get("kappa", 1.0))
            edofs = mesh.elems
            f = load_vector(mesh.coords, mesh.elems, mesh.n_nodes,
                            source=self.params.get("source", 1.0))
        else:
            Ke = p1_elasticity_stiffness(mesh.coords, mesh.elems,
                                         lam=self.params.get("lam", 1.0),
                                         mu=self.params.get("mu", 1.0))
            edofs = element_dofs(mesh.elems, self.dim)
            f = elasticity_load_vector(
                mesh.coords, mesh.elems, mesh.n_nodes,
                self.params.get("body_force", DEFAULT_BODY_FORCE[self.dim]))
        nd = self.n_global_dofs
        K = assemble_scipy_csr(nd, edofs, Ke)
        free = np.setdiff1d(np.arange(nd), self.dirichlet_dofs)
        return K, f, free

    def reference_solution(self, loads: np.ndarray = None) -> np.ndarray:
        """Direct sparse solve of the undecomposed global system with the
        Dirichlet condition (the validation oracle). Returns the
        (n_global_dofs,) solution in node-blocked DOF order. ``loads``
        (an (S, n) per-subdomain stack) replaces the problem's own body
        load with its :meth:`global_load`."""
        import scipy.sparse.linalg as spla

        K, f, free = self._global_system()
        if loads is not None:
            f = self.global_load(loads)
        u = np.zeros(self.n_global_dofs)
        u[free] = spla.spsolve(K[free][:, free].tocsc(), f[free])
        return u

    def reference_solutions(self, cases: np.ndarray) -> np.ndarray:
        """Per-column oracle for an (n_rhs, S, n) load-case stack: one
        sparse factorization, every column solved against it. Returns
        (n_rhs, n_global_dofs) in node-blocked DOF order."""
        import scipy.sparse.linalg as spla

        K, _, free = self._global_system()
        F = np.stack([self.global_load(c)[free] for c in cases], axis=1)
        solve = spla.factorized(K[free][:, free].tocsc())
        U = np.zeros((len(cases), self.n_global_dofs))
        U[:, free] = np.stack([solve(F[:, j]) for j in range(F.shape[1])])
        return U


def _fixing_dofs(problem: str, dim: int, lshape: tuple, lstrides: list,
                 fixing_node: int) -> np.ndarray:
    """k local DOFs with R[fixing_dofs] invertible.

    Heat: the fixing node itself. Elasticity: the 3-2-1 locating fixture
    over spread-out corner nodes of the subdomain box.
    """
    if problem == "heat":
        return np.asarray([fixing_node], dtype=np.int64)
    nx = lshape[0] - 1  # node index of the far x corner
    node_a = 0  # local node (0, 0[, 0])
    node_b = nx * lstrides[0]  # (nx, 0[, 0]): differs from A along x
    if dim == 2:
        # A.ux, A.uy pin translations; B.uy pins the rotation
        return np.asarray([2 * node_a, 2 * node_a + 1, 2 * node_b + 1],
                          dtype=np.int64)
    node_c = (lshape[1] - 1) * lstrides[1]  # (0, ny, 0): off the AB axis
    return np.asarray(
        [3 * node_a, 3 * node_a + 1, 3 * node_a + 2,
         3 * node_b + 1, 3 * node_b + 2,
         3 * node_c + 2],
        dtype=np.int64)


def decompose_problem(
    problem: str,
    dim: int,
    sub_grid: tuple,
    elems_per_sub: tuple,
    kappa: float = 1.0,
    source: float = 1.0,
    lam: float = 1.0,
    mu: float = 1.0,
    body_force=None,
    assemble_values: bool = True,
) -> FetiProblem:
    """Build the total-FETI decomposition of a structured problem.

    Args:
      problem: "heat" (scalar P1, k=1) or "elasticity" (vector P1,
        node-blocked DOFs, k=3/6).
      dim: 2 or 3.
      sub_grid: number of subdomains per axis, e.g. (4, 4) or (2, 2, 2).
      elems_per_sub: elements per axis per subdomain, e.g. (8, 8).
      kappa/source: heat conductivity and source term (heat only).
      lam/mu/body_force: Lamé parameters and constant body force
        (elasticity only; body_force defaults to unit downward gravity).
      assemble_values: if False, build topology/patterns only (K, f and
        B̃ᵀ are 1x1, (1,) and (1, m_max) placeholders; the sizes live in
        ``dof_gids`` and ``b_rows``) — the dry-run's path, which needs the
        stepped/symbolic metadata of production-sized subdomains without
        their dense matrices.
    """
    if problem not in ("heat", "elasticity"):
        raise ValueError(f"unknown problem {problem!r}")
    if dim != len(sub_grid) or dim != len(elems_per_sub):
        raise ValueError("dim / sub_grid / elems_per_sub mismatch")
    ndpn = 1 if problem == "heat" else dim
    if body_force is None:
        body_force = DEFAULT_BODY_FORCE[dim]
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
    n_local = int(np.prod(lshape)) * ndpn

    Ks, fs, gids_per_sub = [], [], []
    for s in sub_list:
        if assemble_values:
            origin = tuple(s[d] * sub_lengths[d] for d in range(dim))
            lmesh = structured_mesh(elems_per_sub, origin=origin,
                                    lengths=sub_lengths)
            if problem == "heat":
                Ke = p1_element_stiffness(lmesh.coords, lmesh.elems,
                                          kappa=kappa)
                edofs = lmesh.elems
                f = load_vector(lmesh.coords, lmesh.elems, lmesh.n_nodes,
                                source=source)
            else:
                Ke = p1_elasticity_stiffness(lmesh.coords, lmesh.elems,
                                             lam=lam, mu=mu)
                edofs = element_dofs(lmesh.elems, dim)
                f = elasticity_load_vector(lmesh.coords, lmesh.elems,
                                           lmesh.n_nodes, body_force)
            Ks.append(assemble_dense(n_local, edofs, Ke))
            fs.append(f)
        else:
            Ks.append(np.zeros((1, 1)))
            fs.append(np.zeros((1,)))
        gnode = lidx + np.array([s[d] * elems_per_sub[d] for d in range(dim)])
        gids_per_sub.append((gnode * np.array(gstrides)).sum(axis=1)
                            .astype(np.int64))

    # shared kernel basis: the local template's constants / rigid modes
    if problem == "heat":
        R_shared = kernel_basis(n_local, "heat")
    else:
        lmesh0 = structured_mesh(elems_per_sub, lengths=sub_lengths)
        R_shared = kernel_basis(problem="elasticity", coords=lmesh0.coords)

    # --- ownership: global node -> [(sub, local_id)] ---
    owners: dict[int, list[tuple[int, int]]] = {}
    for si, gids in enumerate(gids_per_sub):
        for lid, g in enumerate(gids):
            owners.setdefault(int(g), []).append((si, lid))

    # --- multipliers, one per component: chain gluing over the
    # (sub-sorted) copies of each shared node; the Dirichlet x=0 face pins
    # every copy instead (pinning already implies equality) ---
    triplets: list[list[tuple[int, int, float]]] = [[] for _ in range(n_subs)]
    n_lambda = 0
    dirichlet_gids = []
    for g in sorted(owners):
        copies = owners[g]
        if g % gnode_shape[0] == 0:
            dirichlet_gids.append(g)
            for (sa, la) in copies:
                for comp in range(ndpn):
                    triplets[sa].append((la * ndpn + comp, n_lambda, 1.0))
                    n_lambda += 1
        else:
            for (sa, la), (sb, lb) in zip(copies, copies[1:]):
                for comp in range(ndpn):
                    triplets[sa].append((la * ndpn + comp, n_lambda, 1.0))
                    triplets[sb].append((lb * ndpn + comp, n_lambda, -1.0))
                    n_lambda += 1

    m_per_sub = [len(t) for t in triplets]
    m_max = max(m_per_sub)

    # --- fixing node: subdomain center (paper's analytic regularization);
    # the k fixing DOFs generalize it for vector kernels ---
    center = tuple(lshape[d] // 2 for d in range(dim))
    fixing_local = int(sum(center[d] * lstrides[d] for d in range(dim)))
    fix_dofs = _fixing_dofs(problem, dim, lshape, lstrides, fixing_local)

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
        if assemble_values:
            Bt = np.zeros((n_local, m_max), dtype=np.float64)
            Bt[b_rows[:m], np.arange(m)] = b_vals[:m]
        else:
            Bt = np.zeros((1, m_max), dtype=np.float64)
        gids = gids_per_sub[si]
        dof_gids = ((gids[:, None] * ndpn + np.arange(ndpn)).reshape(-1)
                    if ndpn > 1 else gids)
        subdomains.append(SubdomainData(
            index=si, K=Ks[si], f=fs[si], Bt=Bt, lambda_ids=lam_ids, m=m,
            node_gids=gids, dof_gids=dof_gids, fixing_node=fixing_local,
            R=R_shared, fixing_dofs=fix_dofs, b_rows=b_rows, b_vals=b_vals,
        ))

    params = (dict(kappa=kappa, source=source) if problem == "heat"
              else dict(lam=lam, mu=mu, body_force=tuple(body_force)))
    return FetiProblem(
        dim=dim,
        sub_grid=tuple(sub_grid),
        elems_per_sub=tuple(elems_per_sub),
        n_lambda=n_lambda,
        subdomains=subdomains,
        c=np.zeros((n_lambda,), dtype=np.float64),
        global_mesh=gmesh,
        dirichlet_gids=np.asarray(sorted(set(dirichlet_gids)), dtype=np.int64),
        problem=problem,
        ndof_per_node=ndpn,
        kernel_dim=R_shared.shape[1],
        params=params,
    )


def decompose_elasticity_problem(dim: int, sub_grid: tuple,
                                 elems_per_sub: tuple, lam: float = 1.0,
                                 mu: float = 1.0, body_force=None
                                 ) -> FetiProblem:
    """Total-FETI decomposition of structured P1 linear elasticity
    (node-blocked vector DOFs, rigid-body kernels of dimension 3/6)."""
    return decompose_problem("elasticity", dim, sub_grid, elems_per_sub,
                             lam=lam, mu=mu, body_force=body_force)
