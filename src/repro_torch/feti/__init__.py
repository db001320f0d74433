"""FETI solver substrate (paper §2) on torch: batched cluster
preprocessing (factorization + sparsity-utilizing SC assembly), the dual
operator in implicit and explicit form, the natural-coarse-space projector,
PCPG, and the end-to-end solver. :class:`FetiConfig` is the front door."""
from repro_torch.feti.assembly import ClusterState, preprocess_cluster
from repro_torch.feti.config import FetiConfig, as_feti_config
from repro_torch.feti.operator import (
    dual_rhs,
    explicit_dual_apply,
    implicit_dual_apply,
    lumped_preconditioner,
)
from repro_torch.feti.pcpg import PCPGResult, pcpg
from repro_torch.feti.projector import CoarseProblem, build_coarse_problem
from repro_torch.feti.solver import FetiSolution, FetiSolver

__all__ = [
    "ClusterState",
    "CoarseProblem",
    "FetiConfig",
    "FetiSolution",
    "FetiSolver",
    "PCPGResult",
    "as_feti_config",
    "build_coarse_problem",
    "dual_rhs",
    "explicit_dual_apply",
    "implicit_dual_apply",
    "lumped_preconditioner",
    "pcpg",
    "preprocess_cluster",
]
