"""End-to-end FETI solver (paper §2 + §5); counterpart of
``repro.feti.solver`` for one device, f64 and a single load case.

Stages exactly as the paper defines them:
  initialization —  symbolic factorization & persistent structures
                    (inside :func:`repro_torch.feti.assembly.preprocess_cluster`),
  preprocessing  —  numerical factorization + explicit SC assembly,
  solution       —  PCPG iterations applying the dual operator.

Timings are host wall clock (``time.perf_counter``) around work that ends
in a device synchronization, so they measure the device work, not its
enqueue. Multi-RHS solves are ROADMAP item A12, telemetry A15.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import SchurAssemblyConfig
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.feti.assembly import ClusterState, preprocess_cluster
from repro_torch.feti.config import as_feti_config
from repro_torch.feti.operator import (
    dirichlet_preconditioner,
    dual_rhs,
    explicit_dual_apply,
    gather_local,
    implicit_dual_apply,
    lumped_preconditioner,
    solve_with_factor,
)
from repro_torch.feti.pcpg import PCPGResult, pcpg
from repro_torch.feti.projector import CoarseProblem, build_coarse_problem

__all__ = ["FetiSolver", "FetiSolution"]


@dataclasses.dataclass
class FetiSolution:
    u: np.ndarray  # (S, n) subdomain solutions, original DOF order
    u_global: np.ndarray  # (n_global_dofs,) averaged onto the global mesh
    lam: np.ndarray
    alpha: np.ndarray  # (S, k) kernel coefficients per subdomain
    iterations: int
    residual: float
    converged: bool
    timings: dict


@dataclasses.dataclass
class _SolutionOps:
    """Load-independent solution-phase machinery, built once per state."""

    coarse: CoarseProblem
    apply_F: Callable  # (n_lambda,) -> (n_lambda,)
    precond: Optional[Callable]
    c: torch.Tensor  # (n_lambda,) constraint right-hand side


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FetiSolver:
    """Drives preprocess + PCPG for one cluster (batched subdomains).

    ``config`` is a :class:`~repro_torch.feti.config.FetiConfig` or
    ``None`` (defaults). Work runs on
    ``config.device`` — ``cuda`` unless ``device="cpu"`` is passed.
    """

    def __init__(self, problem: FetiProblem, config=None):
        fc = as_feti_config(config)
        self.problem = problem
        self.config = fc
        self.cfg: SchurAssemblyConfig = fc.resolved_schur()
        self.mode = fc.mode
        self.preconditioner = fc.preconditioner
        self.state: Optional[ClusterState] = None
        self.timings: dict = {}
        self._ops: Optional[_SolutionOps] = None

    # ---- preprocessing (paper §2.2) ----
    def preprocess(self) -> ClusterState:
        # f64 end to end: no product on the path may round through TF32.
        # f64 matmuls never take the TF32 path anyway; the flag says so
        # explicitly for whatever f32 work a later slice adds.
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        self.state = preprocess_cluster(self.problem, self.config)
        _sync(self.state.device)
        self._ops = None
        self.timings["preprocess_s"] = time.perf_counter() - t0
        return self.state

    # ---- solution-phase machinery, load-independent ----
    def _solution_ops(self) -> _SolutionOps:
        if self._ops is not None:
            return self._ops
        st = self.state
        prob = self.problem
        Bt_orig = torch.as_tensor(np.stack([sd.Bt for sd in prob.subdomains]),
                                  dtype=torch.float64, device=st.device)
        coarse = build_coarse_problem(Bt_orig, st.f, st.R, st.dual)
        if self.mode == "explicit":
            apply_F = partial(explicit_dual_apply, st.F, st.dual)
        else:
            apply_F = partial(implicit_dual_apply, st.L, st.Btp, st.dual)
        if self.preconditioner == "lumped":
            # K is packed in factor row order, so it pairs with Btp (the
            # product B̃ K B̃ᵀ is invariant to the shared row permutation)
            precond = partial(lumped_preconditioner, st.K, st.Btp, st.dual)
        elif self.preconditioner == "dirichlet":
            if st.Sb is None:
                raise ValueError(
                    "state was preprocessed without the dirichlet stage; "
                    "construct the solver with preconditioner='dirichlet' "
                    "before preprocess()")
            precond = partial(dirichlet_preconditioner, st.Sb, st.Btb,
                              st.dual)
        else:
            precond = None
        c = torch.as_tensor(prob.c, dtype=torch.float64, device=st.device)
        self._ops = _SolutionOps(coarse=coarse, apply_F=apply_F,
                                 precond=precond, c=c)
        return self._ops

    def _recover_u(self, up: torch.Tensor, alpha_flat: torch.Tensor):
        """Factor-order K⁺(f − Bᵀλ) + kernel correction, back to original
        DOF order, averaged onto the global mesh (host numpy)."""
        st = self.state
        prob = self.problem
        k = st.R.shape[2]
        inv_perm = np.argsort(st.node_perm)
        alpha = alpha_flat.cpu().numpy().reshape(st.S, k)
        u = (up.cpu().numpy()[:, inv_perm]
             + np.einsum("snk,sk->sn", st.R.cpu().numpy(), alpha))
        nn = prob.n_global_dofs
        acc = np.zeros(nn)
        cnt = np.zeros(nn)
        for i, sd in enumerate(prob.subdomains):
            np.add.at(acc, sd.dof_gids, u[i])
            np.add.at(cnt, sd.dof_gids, 1.0)
        return u, alpha, acc / np.maximum(cnt, 1.0)

    # ---- solution (paper §2.2) ----
    def solve(self, tol: float = 1e-9, max_iter: int = 2000) -> FetiSolution:
        """One PCPG solve of the problem's own load."""
        if self.state is None:
            self.preprocess()
        st = self.state
        ops = self._solution_ops()
        coarse = ops.coarse

        t0 = time.perf_counter()
        lam0 = coarse.lambda0()
        d = dual_rhs(st.L, st.Btp, st.fp, st.dual, ops.c)
        _sync(st.device)
        self.timings["rhs_setup_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        res: PCPGResult = pcpg(ops.apply_F, coarse.project, d, lam0,
                               precondition=ops.precond, tol=tol,
                               max_iter=max_iter)
        _sync(st.device)
        self.timings["solve_s"] = time.perf_counter() - t0

        # ---- recover α and u (paper eqs. 5, 7) ----
        t0 = time.perf_counter()
        lam = res.lam
        alpha_flat = coarse.alpha(ops.apply_F(lam) - d)  # (S·k,), sd-major
        rhs = st.fp - (st.Btp @ gather_local(lam, st.dual).unsqueeze(-1)
                       ).squeeze(-1)
        up = solve_with_factor(st.L, rhs)
        u, alpha, u_global = self._recover_u(up, alpha_flat)
        self.timings["recover_s"] = time.perf_counter() - t0

        return FetiSolution(
            u=u, u_global=u_global, lam=lam.cpu().numpy(), alpha=alpha,
            iterations=res.iterations, residual=res.residual,
            converged=res.converged, timings=dict(self.timings),
        )

    def solve_many(self, *args, **kwargs):
        raise NotImplementedError("multi-RHS solves are ROADMAP item A12")

    def report(self):
        raise NotImplementedError("telemetry (repro.obs) is ROADMAP item A15")
