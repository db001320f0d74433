"""Dirichlet preconditioner: the *primal* boundary/interior Schur stage
(counterpart of ``repro.feti.dirichlet``).

The FETI Dirichlet preconditioner

    M⁻¹ = Σᵢ B̃ᵢ S_b,i B̃ᵢᵀ,   S_b = K_bb − K_bi K_ii⁻¹ K_ib

is a second family of Schur complements, assembled per subdomain onto the
*boundary* DOFs (the rows B̃ᵀ touches) instead of onto the multipliers.
With L_ii the Cholesky factor of K_ii,

    K_bi K_ii⁻¹ K_ib = (L_ii⁻¹ K_ib)ᵀ (L_ii⁻¹ K_ib)

is exactly the TRSM+SYRK product the dual-operator assembly computes
(paper eq. 14) with K_ib as the sparse right-hand side, so this module
reuses :func:`repro_torch.core.schur.make_assembler` verbatim: the
interior gets its own fill-reducing ordering and block fill mask, K_ib its
own stepped column metadata, and every assembly variant and hand-written
kernel of the dual stage runs the preconditioner stage unchanged.

Conventions (as in the reference):

* **Boundary** = every DOF carrying a B̃ᵀ row in *any* subdomain of the
  cluster, so the split, and with it every symbolic product, is shared.
  For vector problems the split is node-blocked.
* **Interior** DOFs are ordered by the restriction of the subdomain's
  fill-reducing ordering; boundary DOFs keep their original order, so
  ``B̃ᵀ[boundary]`` needs no column bookkeeping.
* A subdomain at the cluster's outer surface has union-boundary DOFs that
  carry none of ITS multipliers; :func:`restrict_own_boundary` eliminates
  them per subdomain as a dense batched epilogue.
* S_b is assembled from the **unregularized** K: K_ii is SPD outright, and
  the fixing-DOF shift would perturb S_b on boundary diagonal entries.

Everything symbolic is host numpy; the numeric stage runs on the stacks'
device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (
    SchurAssemblyConfig,
    build_stepped_meta,
    column_pivots,
    make_assembler,
)
from repro_torch.core.autotune import pattern_fingerprint
from repro_torch.core.precision import canonical_dtype, compute_dtype
from repro_torch.core.stepped import SteppedMeta
from repro_torch.device import resolve_device
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.fem.meshgen import structured_mesh
from repro_torch.sparse import (
    PackedBlockIndex,
    PackedBlocks,
    block_cholesky,
    block_cholesky_packed,
    block_pattern,
    block_symbolic_cholesky,
    matrix_pattern_from_elems,
    node_ordering,
)

__all__ = [
    "BoundaryInteriorSplit",
    "DirichletBlocks",
    "boundary_interior_split",
    "dirichlet_symbolic",
    "dirichlet_fingerprint",
    "make_dirichlet_assembler",
    "own_boundary_masks",
    "restrict_own_boundary",
    "assemble_dirichlet_schur",
]


@dataclasses.dataclass(frozen=True)
class BoundaryInteriorSplit:
    """The shared boundary/interior partition of one cluster's local DOFs.

    ``interior`` is already in the interior fill-reducing elimination
    order; ``boundary`` is in ascending original (node-blocked) DOF order.
    ``dperm = [interior; boundary]`` is the row/column permutation that
    brings every subdomain's K into the 2x2 primal Schur layout.
    """

    n: int  # local DOFs per subdomain
    interior: np.ndarray  # (n_i,) original DOF ids, fill-reducing order
    boundary: np.ndarray  # (n_b,) original DOF ids, ascending

    @property
    def n_i(self) -> int:
        return len(self.interior)

    @property
    def n_b(self) -> int:
        return len(self.boundary)

    @property
    def dperm(self) -> np.ndarray:
        return np.concatenate([self.interior, self.boundary])

    def validate_partition(self) -> None:
        """boundary ∪ interior = all DOFs, disjoint."""
        both = np.concatenate([self.interior, self.boundary])
        if len(both) != self.n or len(np.unique(both)) != self.n:
            raise ValueError("boundary/interior do not partition the DOFs")


def boundary_interior_split(
    problem: FetiProblem,
    ordering: str = "nd",
    dof_perm: Optional[np.ndarray] = None,
) -> BoundaryInteriorSplit:
    """Classify the cluster's local DOFs as boundary (any B̃ᵀ row across
    the cluster's subdomains) vs interior, node-blocked for vector DOFs.

    ``dof_perm`` is the expanded fill-reducing DOF permutation the cluster
    preprocessor already computed; ``None`` rebuilds it from ``ordering``.
    The interior keeps its relative order in it, which preserves the
    separator structure (and hence the low fill) on the sub-box.
    """
    subs = problem.subdomains
    n = subs[0].n
    ndpn = problem.ndof_per_node
    bmask = np.zeros(n, dtype=bool)
    for sd in subs:
        bmask[sd.b_rows[: sd.m]] = True
    if ndpn > 1:
        bmask = np.repeat(bmask.reshape(-1, ndpn).any(axis=1), ndpn)
    if not bmask.any():
        raise ValueError("no boundary DOFs: the decomposition has no "
                         "multipliers, so there is nothing to precondition")
    if dof_perm is None:
        from repro_torch.feti.assembly import expand_node_perm

        node_shape = tuple(e + 1 for e in problem.elems_per_sub)
        dof_perm = expand_node_perm(node_ordering(node_shape, ordering), ndpn)
    elif len(dof_perm) != n:
        raise ValueError(f"dof_perm has {len(dof_perm)} entries for {n} "
                         "local DOFs")
    split = BoundaryInteriorSplit(
        n=n, interior=dof_perm[~bmask[dof_perm]],
        boundary=np.flatnonzero(bmask).astype(np.int64))
    split.validate_partition()
    return split


def _local_dof_pattern(problem: FetiProblem) -> np.ndarray:
    """Dense boolean pattern of one subdomain's K in original DOF order."""
    from repro_torch.feti.assembly import expand_node_pattern

    lmesh = structured_mesh(problem.elems_per_sub)
    npat = matrix_pattern_from_elems(lmesh.n_nodes, lmesh.elems)
    return expand_node_pattern(npat, problem.ndof_per_node)


def dirichlet_symbolic(
    problem: FetiProblem,
    split: BoundaryInteriorSplit,
    block_size: int,
    rhs_block_size: Optional[int] = None,
    kpat: Optional[np.ndarray] = None,
) -> Tuple[SteppedMeta, np.ndarray]:
    """Symbolic products of the primal Schur stage, shared by the cluster.

    Returns ``(meta_ib, mask_ii)``: the stepped column metadata of the
    (n_i, n_b) right-hand side K_ib (its columns are boundary DOFs whose
    pivot is their first interior neighbour in elimination order) and the
    interior factor's block fill mask. ``kpat`` is the original-order DOF
    pattern when the caller holds it.
    """
    if kpat is None:
        kpat = _local_dof_pattern(problem)
    P, B = split.interior, split.boundary
    mask_ii = block_symbolic_cholesky(block_pattern(kpat[P][:, P], block_size))
    meta_ib = build_stepped_meta(
        kpat[P][:, B], block_size=block_size,
        rhs_block_size=rhs_block_size or block_size)
    return meta_ib, mask_ii


def dirichlet_fingerprint(problem: FetiProblem,
                          split: BoundaryInteriorSplit,
                          kpat: Optional[np.ndarray] = None) -> str:
    """Content hash of the Dirichlet stage's sparsity inputs, for the plan
    cache (the reference's digest on the same problem): K_ib's column
    pivots, the interior's row degrees and order. Distinct from the dual
    stage's fingerprint by construction, and the cache key carries the
    stage name besides. ``kpat`` is the original-order DOF pattern when the
    caller holds it."""
    if kpat is None:
        kpat = _local_dof_pattern(problem)
    pat_ib = kpat[split.interior][:, split.boundary]
    row_deg = kpat[split.interior][:, split.interior].sum(axis=1)
    return pattern_fingerprint(
        column_pivots(pat_ib), split.n_i, split.n_b,
        extra=[row_deg.astype(np.int64), split.interior])


def own_boundary_masks(problem: FetiProblem,
                       split: BoundaryInteriorSplit,
                       owned: Optional[range] = None) -> np.ndarray:
    """(S, n_b) float mask, 1.0 where the shared boundary DOF carries NONE
    of that subdomain's multipliers (its "spurious" boundary: faces on the
    cluster's outer surface), which :func:`restrict_own_boundary`
    eliminates per subdomain. ``owned`` (one rank's slice of the
    subdomains) keeps only those rows; the split stays the cluster's."""
    ndpn = problem.ndof_per_node
    subs = [problem.subdomains[i] for i in
            (owned if owned is not None else range(problem.n_subdomains))]
    Z = np.zeros((len(subs), split.n_b))
    for i, sd in enumerate(subs):
        own = np.zeros(sd.n, dtype=bool)
        own[sd.b_rows[: sd.m]] = True
        if ndpn > 1:
            own = np.repeat(own.reshape(-1, ndpn).any(axis=1), ndpn)
        Z[i] = (~own[split.boundary]).astype(np.float64)
    return Z


def restrict_own_boundary(Sb: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Eliminate each subdomain's spurious boundary DOFs from its union
    Schur complement, batched over the (S, n_b, n_b) stack. Schur
    complements compose, so

        S_own = S − (Z S)ᵀ E⁻¹ (Z S),   E = Z S Z + diag(1 − z),

    with Z = diag(z), is the Schur complement of K onto exactly the
    subdomain's glued DOFs, embedded in the shared frame with exact zero
    spurious rows and columns. ``z`` all-zero gives E = I: a no-op.
    """
    E = Sb * z[:, :, None] * z[:, None, :] + torch.diag_embed(1.0 - z)
    C = torch.linalg.cholesky(E)
    ZS = z[:, :, None] * Sb
    return Sb - ZS.mT @ torch.cholesky_solve(ZS, C)


class DirichletBlocks:
    """The Dirichlet stage's device inputs for ``S`` subdomains (all of
    them, or one rank's slice), cut from each subdomain's K as it reaches
    the device: K_ib (S, n_i, n_b), K_bb (S, n_b, n_b) and, when
    the interior factor is not shared, K_ii — dense (S, n_i, n_i), or
    packed straight from the upload in ``index_ii``'s layout (one gather,
    identity-padded), so the packed path builds no dense interior stack.

    ``storage`` is the stacks' storage dtype (default f64): each cut is
    rounded to it as it lands, in a stack held at the dtype its math runs
    in (:func:`~repro_torch.core.precision.compute_dtype`; f32 for bf16).
    """

    def __init__(self, split: BoundaryInteriorSplit, S: int,
                 device: torch.device, interior: bool = False,
                 index_ii: Optional[PackedBlockIndex] = None,
                 storage: torch.dtype = torch.float64):
        ni, nb = split.n_i, split.n_b
        self.n = split.n
        self._storage = storage
        self._int = torch.as_tensor(split.interior, device=device)
        self._bnd = torch.as_tensor(split.boundary, device=device)
        at = dict(dtype=compute_dtype(storage), device=device)
        self.Kib = torch.empty((S, ni, nb), **at)
        self.Kbb = torch.empty((S, nb, nb), **at)
        self.Kii = None
        self._gather = None
        if interior and index_ii is not None:
            self._gather = torch.as_tensor(
                index_ii.flat_gather(split.interior, split.n), device=device)
            bs = index_ii.bs
            self.Kii = PackedBlocks(
                torch.empty((S, index_ii.n_blocks, bs, bs), **at), index_ii)
        elif interior:
            self.Kii = torch.empty((S, ni, ni), **at)

    def add(self, i: int, flat: torch.Tensor) -> None:
        """Cut subdomain ``i``'s blocks from its f64 K on the device, given
        flattened (n·n,) with one zero appended."""
        n, sdt = self.n, self._storage
        Ki = flat[: n * n].view(n, n)
        rows = Ki[self._int]
        self.Kib[i] = rows[:, self._bnd].to(sdt)
        self.Kbb[i] = Ki[self._bnd][:, self._bnd].to(sdt)
        if isinstance(self.Kii, PackedBlocks):
            index = self.Kii.index
            vals = self.Kii.values
            vals[i] = flat[self._gather].view(vals.shape[1:]).to(sdt)
            index.set_identity_pad(vals[i])
        elif self.Kii is not None:
            self.Kii[i] = rows[:, self._int].to(sdt)

    def upload(self, problem: FetiProblem,
               owned: Optional[range] = None) -> "DirichletBlocks":
        """Fill every subdomain's blocks (those of ``owned``, one rank's
        slice, when given) from its host K, one upload each: for callers
        that build no dual-stage stack beside them."""
        n = self.n
        flat = torch.zeros(n * n + 1, dtype=torch.float64,
                           device=self.Kib.device)
        if owned is None:
            owned = range(problem.n_subdomains)
        for i, sd in enumerate(problem.subdomains[j] for j in owned):
            flat[: n * n].copy_(torch.as_tensor(sd.K, dtype=torch.float64)
                                .reshape(-1))
            self.add(i, flat)
        return self


def make_dirichlet_assembler(
    split: BoundaryInteriorSplit,
    meta_ib: SteppedMeta,
    mask_ii: np.ndarray,
    cfg: SchurAssemblyConfig,
    shared: bool = False,
) -> Callable[..., torch.Tensor]:
    """Build the batched S_b assembler of one cluster.

    Returns ``assemble(A_ii, Kib, Kbb) -> S_b`` (S, n_b, n_b); ``Kib`` is
    (S, n_i, n_b) and ``Kbb`` (S, n_b, n_b), both unregularized, boundary
    columns in ``split.boundary`` order. Unshared, ``A_ii`` is the K_ii
    stack (dense, or packed in the interior fill-mask layout), factorized
    IN PLACE here. ``shared=True`` elides that factorization: ``A_ii`` is then the
    interior factor itself, the dual factor's leading (n_i, n_i) principal
    block (valid when the dual rows follow ``split.dperm`` and the
    regularization touches only boundary DOFs). The factor's storage and
    the TRSM/SYRK schedule follow ``cfg``, as in the dual stage; a dense
    factor under a packed ``cfg`` is packed by the assembler.
    """
    if split.n_i == 0:
        # degenerate split (every DOF glued): S_b = K_bb, nothing to solve
        return lambda A_ii, Kib, Kbb: Kbb
    assembler = make_assembler(meta_ib, cfg, mask_ii)

    def assemble(A_ii, Kib: torch.Tensor, Kbb: torch.Tensor) -> torch.Tensor:
        if shared:
            L = A_ii
        elif isinstance(A_ii, PackedBlocks):
            L = block_cholesky_packed(A_ii, A_ii.index)
        else:
            L = block_cholesky(A_ii, cfg.block_size, mask=mask_ii)
        return Kbb - assembler(L, Kib)

    return assemble


def assemble_dirichlet_schur(
    problem: FetiProblem,
    cfg: Optional[SchurAssemblyConfig] = None,
    ordering: str = "nd",
    restrict: bool = True,
    device=None,
    dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor, BoundaryInteriorSplit]:
    """One-shot convenience: (S_b stack, boundary B̃ᵀ stack, split), from
    the unregularized K with its own interior factorization.

    The standalone entry point for tests and benchmarks;
    :func:`repro_torch.feti.assembly.preprocess_cluster` threads the same
    pieces through its preprocessing. ``restrict=False`` skips the
    own-boundary restriction and returns the shared union Schur
    complement. ``device`` defaults to ``cuda``. ``dtype`` is the storage
    dtype (default f64): K is rounded to it, the stage runs at its compute
    dtype (f32 for bf16) and S_b and B̃ᵀ come back at it.
    """
    cfg = cfg or SchurAssemblyConfig()
    dev = resolve_device(device)
    sdt = canonical_dtype(torch.float64 if dtype is None else dtype)
    cdt = compute_dtype(sdt)
    split = boundary_interior_split(problem, ordering=ordering)
    meta_ib, mask_ii = dirichlet_symbolic(problem, split, cfg.block_size,
                                          cfg.rhs_bs)
    index_ii = (PackedBlockIndex.from_mask(mask_ii, split.n_i, cfg.block_size)
                if cfg.storage == "packed" else None)
    subs = problem.subdomains
    blocks = DirichletBlocks(split, len(subs), dev, interior=True,
                             index_ii=index_ii, storage=sdt).upload(problem)
    assemble = make_dirichlet_assembler(split, meta_ib, mask_ii, cfg)
    Sb = assemble(blocks.Kii, blocks.Kib, blocks.Kbb)
    if restrict:
        Z = torch.as_tensor(own_boundary_masks(problem, split),
                            dtype=cdt, device=dev)
        Sb = restrict_own_boundary(Sb, Z)
    Btb = torch.as_tensor(np.stack([sd.Bt[split.boundary] for sd in subs]),
                          dtype=sdt, device=dev)
    return Sb.to(sdt), Btb, split
