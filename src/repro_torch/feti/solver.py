"""End-to-end FETI solver (paper §2 + §5); counterpart of
``repro.feti.solver`` for one device and a single load case, at f64 or with
reduced-precision stacks (f32, bf16) and refinement.

Stages exactly as the paper defines them:
  initialization —  symbolic factorization & persistent structures
                    (inside :func:`repro_torch.feti.assembly.preprocess_cluster`),
  preprocessing  —  numerical factorization + explicit SC assembly,
  solution       —  PCPG iterations applying the dual operator.

Mixed precision (``FetiConfig.dtype`` below f64, ``refine`` > 0): the PCPG
vectors run at f64 (the solve dtype) and every application of a stored
reduced-precision operator is cast explicitly around it. Implicit mode
applies F through refined interior solves, f64-accurate by construction.
Explicit mode runs the reduced-precision F̃ down to that dtype's floor,
then defect-correction outer iterations recover f64 accuracy: each
measures the true residual with the refined implicit apply and solves
P F δ = P r for a correction.

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
from repro_torch.core.precision import dtype_name, tol_floor
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.feti.assembly import ClusterState, preprocess_cluster
from repro_torch.feti.config import as_feti_config
from repro_torch.feti.operator import (
    dirichlet_preconditioner,
    dual_rhs,
    dual_rhs_refined,
    explicit_dual_apply,
    gather_local,
    implicit_dual_apply,
    implicit_dual_apply_refined,
    lumped_preconditioner,
    solve_with_factor,
    solve_with_factor_refined,
)
from repro_torch.feti.pcpg import PCPGResult, pcpg
from repro_torch.feti.projector import CoarseProblem, build_coarse_problem

__all__ = ["FetiSolver", "FetiSolution"]

# defect-correction outer iterations (explicit mode on a reduced-precision
# F̃): each outer solves P F δ = P r to the storage dtype's floor and
# contracts the f64 residual by about that floor, so a handful suffices; the
# cap is a stagnation guard, not a tuning knob
_MAX_OUTER = 8


@dataclasses.dataclass
class FetiSolution:
    u: np.ndarray  # (S, n) subdomain solutions, original DOF order
    u_global: np.ndarray  # (n_global_dofs,) averaged onto the global mesh
    lam: np.ndarray
    alpha: np.ndarray  # (S, k) kernel coefficients per subdomain
    iterations: int  # PCPG iterations, summed over defect-correction outers
    residual: float
    converged: bool
    timings: dict
    refine_outer: int = 0  # defect-correction outer iterations performed
    # (iterations,) ‖P r‖ per PCPG iteration, concatenated across the
    # outers; only from solve(history=True)
    residual_history: Optional[np.ndarray] = None
    storage_dtype: str = "f64"  # the stacks' dtype
    compute_dtype: str = "f64"  # the factorization's, TRSM's and SYRK's
    solve_dtype: str = "f64"  # the PCPG vectors'


@dataclasses.dataclass
class _SolutionOps:
    """Load-independent solution-phase machinery, built once per state."""

    coarse: CoarseProblem
    apply_F: Callable  # (n_lambda,) -> (n_lambda,): the operator PCPG runs
    # (the reduced-precision F̃ under mixed-precision explicit mode)
    apply_F_exact: Callable  # f64-accurate application (the refined
    # implicit one) for outer residuals and α; apply_F when not refining
    precond: Optional[Callable]
    dual_rhs: Callable  # fp (S, n) -> d (n_lambda,)
    Bt: torch.Tensor  # (S, n, m_max) B̃ᵀ in factor row order, solve dtype


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
        # no f32 product on the path may round through TF32 (10-bit
        # mantissa): the f32 stacks and the kernels' plain versions run in
        # full f32, as the reference's do
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
        vdt = self.config.solve_dtype  # f64 when refining, else storage
        stor = self.config.storage_dtype
        refine = st.refine_steps
        Bt_orig = torch.as_tensor(np.stack([sd.Bt for sd in prob.subdomains]),
                                  dtype=vdt, device=st.device)
        coarse = build_coarse_problem(Bt_orig, st.f, st.R, st.dual)
        c = torch.as_tensor(prob.c, dtype=vdt, device=st.device)
        # B̃ᵀ at the solve dtype, cast once (exact: it holds ±1 and 0); the
        # stored stack itself when that is its dtype
        Bt = st.Btp.to(vdt)
        if self.mode == "explicit":
            apply_F = partial(explicit_dual_apply, st.F, st.dual)
        elif refine > 0:
            # the refined implicit operator is f64-accurate by itself, so
            # plain PCPG reaches f64 tolerances with it
            apply_F = partial(implicit_dual_apply_refined, st.L, st.Kreg,
                              Bt, st.dual, refine)
        else:
            apply_F = partial(implicit_dual_apply, st.L, st.Btp, st.dual)
        if refine > 0:
            apply_F_exact = partial(implicit_dual_apply_refined, st.L,
                                    st.Kreg, Bt, st.dual, refine)
            rhs = partial(dual_rhs_refined, st.L, st.Kreg, Bt,
                          dm=st.dual, steps=refine, c=c)
        else:
            apply_F_exact = apply_F
            rhs = partial(dual_rhs, st.L, st.Btp, dm=st.dual, c=c)
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
        if vdt != stor:
            # mixed precision: the vectors are f64, the stored operators
            # reduced; cast around each application so its product runs at
            # the storage dtype (torch would refuse the mix; the reference
            # casts the same way so jnp does not promote the stack to f64)
            def _fast(fn):
                return lambda x: fn(x.to(stor)).to(vdt)

            if self.mode == "explicit":
                apply_F = _fast(apply_F)
            if precond is not None:
                precond = _fast(precond)
        self._ops = _SolutionOps(coarse=coarse, apply_F=apply_F,
                                 apply_F_exact=apply_F_exact, precond=precond,
                                 dual_rhs=lambda fp: rhs(fp=fp), Bt=Bt)
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
    def solve(self, tol: float = 1e-9, max_iter: int = 2000,
              history: bool = False) -> FetiSolution:
        """One PCPG solve of the problem's own load.

        ``history=True`` records the per-iteration ‖P r‖ on
        ``FetiSolution.residual_history``, concatenated across
        defect-correction outers; ``lam`` is bit-identical to the
        ``history=False`` solve.
        """
        if self.state is None:
            self.preprocess()
        st = self.state
        ops = self._solution_ops()
        coarse = ops.coarse
        fc = self.config

        t0 = time.perf_counter()
        lam0 = coarse.lambda0()
        d = ops.dual_rhs(st.fp)
        _sync(st.device)
        self.timings["rhs_setup_s"] = time.perf_counter() - t0

        # mixed precision, explicit mode: the inner PCPG runs the reduced
        # F̃ down to its dtype's floor, then the outers recover f64
        mixed = st.refine_steps > 0 and self.mode == "explicit"
        inner_tol = max(tol, tol_floor(fc.storage_dtype)) if mixed else tol

        def run(rhs, start):
            return pcpg(ops.apply_F, coarse.project, rhs, start,
                        precondition=ops.precond, tol=inner_tol,
                        max_iter=max_iter, history=history)

        t0 = time.perf_counter()
        res: PCPGResult = run(d, lam0)
        lam = res.lam
        iterations, residual, converged = (res.iterations, res.residual,
                                           res.converged)
        hist = list(res.residual_history or ())
        n_outer = 0
        if mixed:
            # the target scale is pcpg's: tol · ‖P(d − F λ⁰)‖ (the fast
            # operator is accurate enough to set a scale)
            w0n = float(torch.linalg.norm(coarse.project(d - ops.apply_F(lam0))))
            target = tol * max(w0n, 1e-300)
            r = d - ops.apply_F_exact(lam)
            wnorm = float(torch.linalg.norm(coarse.project(r)))
            prev = float("inf")
            while (wnorm > target and n_outer < _MAX_OUTER
                   and wnorm < 0.5 * prev):
                prev = wnorm
                cres = run(r, torch.zeros_like(lam))
                lam = lam + cres.lam
                hist += cres.residual_history or ()
                iterations += cres.iterations
                n_outer += 1
                r = d - ops.apply_F_exact(lam)
                wnorm = float(torch.linalg.norm(coarse.project(r)))
            residual = wnorm
            converged = wnorm <= target
        _sync(st.device)
        self.timings["solve_s"] = time.perf_counter() - t0

        # ---- recover α and u (paper eqs. 5, 7) ----
        t0 = time.perf_counter()
        alpha_flat = coarse.alpha(ops.apply_F_exact(lam) - d)  # (S·k,)
        rhs = st.fp - (ops.Bt @ gather_local(lam, st.dual).unsqueeze(-1)
                       ).squeeze(-1)
        if st.refine_steps > 0:
            up = solve_with_factor_refined(st.L, st.Kreg, rhs,
                                           st.refine_steps)
        else:
            up = solve_with_factor(st.L, rhs)
        u, alpha, u_global = self._recover_u(up, alpha_flat)
        self.timings["recover_s"] = time.perf_counter() - t0

        return FetiSolution(
            u=u, u_global=u_global, lam=lam.cpu().numpy(), alpha=alpha,
            iterations=iterations, residual=residual, converged=converged,
            timings=dict(self.timings), refine_outer=n_outer,
            residual_history=np.asarray(hist) if history else None,
            storage_dtype=fc.dtype_name,
            compute_dtype=dtype_name(fc.compute_dtype),
            solve_dtype=dtype_name(fc.solve_dtype),
        )

    def solve_many(self, *args, **kwargs):
        raise NotImplementedError("multi-RHS solves are ROADMAP item A12")

    def report(self):
        raise NotImplementedError("telemetry (repro.obs) is ROADMAP item A15")
