"""FETI solver substrate (paper §2) on torch: batched cluster
preprocessing (factorization + sparsity-utilizing SC assembly), the dual
operator in implicit and explicit form, the natural-coarse-space projector,
PCPG, and the end-to-end solver with its telemetry (``FetiSolver.report``,
``FetiSolver.amortization_report``), on one device or split over
``torch.distributed`` ranks (:mod:`repro_torch.feti.sharded`,
``FetiConfig.mesh``). :class:`FetiConfig` is the front door."""
from repro_torch.core.stages import StageGraph, StageSpec
from repro_torch.feti.assembly import ClusterState, preprocess_cluster
from repro_torch.feti.config import FetiConfig, as_feti_config
from repro_torch.feti.dirichlet import (
    BoundaryInteriorSplit,
    assemble_dirichlet_schur,
    boundary_interior_split,
)
from repro_torch.feti.operator import (
    dirichlet_preconditioner,
    dual_rhs,
    explicit_dual_apply,
    implicit_dual_apply,
    lumped_preconditioner,
)
from repro_torch.feti.pcpg import PCPGManyResult, PCPGResult, pcpg, pcpg_many
from repro_torch.feti.projector import CoarseProblem, build_coarse_problem
from repro_torch.feti.solver import (
    FetiManySolution,
    FetiSolution,
    FetiSolver,
    solve_many,
)

__all__ = [
    "BoundaryInteriorSplit",
    "ClusterState",
    "CoarseProblem",
    "FetiConfig",
    "FetiManySolution",
    "FetiSolution",
    "FetiSolver",
    "PCPGManyResult",
    "PCPGResult",
    "StageGraph",
    "StageSpec",
    "as_feti_config",
    "assemble_dirichlet_schur",
    "boundary_interior_split",
    "build_coarse_problem",
    "dirichlet_preconditioner",
    "dual_rhs",
    "explicit_dual_apply",
    "implicit_dual_apply",
    "lumped_preconditioner",
    "pcpg",
    "pcpg_many",
    "preprocess_cluster",
    "solve_many",
]
