"""End-to-end FETI solver (paper §2 + §5); counterpart of
``repro.feti.solver`` for one device, one load case (``solve``) or a batch
of them through the block PCPG (``solve_many``), at f64 or with
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
enqueue. Telemetry (``report``) is ROADMAP item A15; the sharded multi-RHS
batch A16.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import Plan, SchurAssemblyConfig
from repro_torch.core.precision import dtype_name, tol_floor
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.feti.assembly import ClusterState, preprocess_cluster
from repro_torch.feti.config import as_feti_config
from repro_torch.feti.operator import (
    batched_apply,
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
from repro_torch.feti.pcpg import PCPGManyResult, PCPGResult, pcpg, pcpg_many
from repro_torch.feti.projector import (
    CoarseProblem,
    build_coarse_problem,
    coarse_e,
)

__all__ = ["FetiSolver", "FetiSolution", "FetiManySolution", "solve_many"]

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
class FetiManySolution:
    """A batch of load-case solutions from :meth:`FetiSolver.solve_many`;
    every array has the load case first."""

    u: np.ndarray  # (n_rhs, S, n) subdomain solutions, original DOF order
    u_global: np.ndarray  # (n_rhs, n_global_dofs)
    lam: np.ndarray  # (n_rhs, n_lambda)
    alpha: np.ndarray  # (n_rhs, S, k)
    iterations: np.ndarray  # (n_rhs,) per-column PCPG iterations (summed
    # over the defect-correction outers)
    residuals: np.ndarray  # (n_rhs,) per-column final ||P r||
    converged: np.ndarray  # (n_rhs,) bool
    block_iterations: int  # block-PCPG trips, summed over the outers
    n_rhs: int  # load cases solved
    timings: dict
    refine_outer: int = 0  # defect-correction outer iterations performed
    # (n_rhs, block_iterations) ‖P r‖ per trip and column (converged
    # columns repeat their frozen value); only from solve_many(history=True)
    residual_history: Optional[np.ndarray] = None
    storage_dtype: str = "f64"
    compute_dtype: str = "f64"
    solve_dtype: str = "f64"


@dataclasses.dataclass
class _SolutionOps:
    """Load-independent solution-phase machinery, built once per state and
    shared by :meth:`FetiSolver.solve` and :meth:`FetiSolver.solve_many`.
    Every member takes a vector or a column stack of them (the operators
    are rank-generic)."""

    coarse: CoarseProblem
    apply_F: Callable  # (n_lambda[, r]) -> same: the operator PCPG runs
    # (the reduced-precision F̃ under mixed-precision explicit mode)
    apply_F_exact: Callable  # f64-accurate application (the refined
    # implicit one) for outer residuals and α; apply_F when not refining
    precond: Optional[Callable]
    dual_rhs: Callable  # fp (S, n[, r]) -> d (n_lambda[, r])
    Bt: torch.Tensor  # (S, n, m_max) B̃ᵀ in factor row order, solve dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FetiSolver:
    """Drives preprocess + PCPG for one cluster (batched subdomains).

    ``config`` is a :class:`~repro_torch.feti.config.FetiConfig` or
    ``None`` (defaults). Work runs on
    ``config.device`` — ``cuda`` unless ``device="cpu"`` is passed.
    ``cfg`` and ``plan`` are the dual stage's resolved config and, under
    ``schur="auto"``, the autotuner's plan: set by :meth:`preprocess`
    (``cfg`` is None before it when the config autotunes).
    """

    def __init__(self, problem: FetiProblem, config=None):
        fc = as_feti_config(config)
        self.problem = problem
        self.config = fc
        self.cfg: Optional[SchurAssemblyConfig] = (
            None if fc.auto else fc.resolved_schur())
        self.plan: Optional[Plan] = None
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
        self.cfg = self.state.cfg  # resolved when "auto" was passed
        self.plan = self.state.plan
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
        self._ops = _SolutionOps(
            coarse=coarse, apply_F=apply_F, apply_F_exact=apply_F_exact,
            precond=precond, dual_rhs=lambda fp: rhs(fp=fp), Bt=Bt)
        return self._ops

    def _load_stacks(self, loads: np.ndarray):
        """Host (S, n, ...) loads in original DOF order -> device (f, fp)
        at the solve dtype, fp in factor row order."""
        st = self.state
        f = torch.as_tensor(np.asarray(loads), dtype=self.config.solve_dtype,
                            device=st.device)
        return f, f[:, torch.as_tensor(st.node_perm, device=st.device)]

    def _recover(self, ops: _SolutionOps, lam: torch.Tensor,
                   d: torch.Tensor, fp: torch.Tensor):
        """α (paper eq. 7) and u = K⁺(f − Bᵀλ) + Rα (eq. 5), back to
        original DOF order and averaged onto the global mesh (host numpy).
        An (n_lambda, n_rhs) ``lam`` recovers that many stacked columns,
        the load case leading."""
        st = self.state
        prob = self.problem
        alpha_flat = ops.coarse.alpha(ops.apply_F_exact(lam) - d)  # (S·k,..)
        rhs = fp - batched_apply(ops.Bt, gather_local(lam, st.dual))
        if st.refine_steps > 0:
            up = solve_with_factor_refined(st.L, st.Kreg, rhs,
                                           st.refine_steps)
        else:
            up = solve_with_factor(st.L, rhs)
        n_cols = lam.shape[1] if lam.dim() == 2 else None
        k = st.R.shape[2]
        inv_perm = np.argsort(st.node_perm)
        R = st.R.cpu().numpy()
        if n_cols is None:
            alpha = alpha_flat.cpu().numpy().reshape(st.S, k)
            u = up.cpu().numpy()[:, inv_perm] + np.einsum("snk,sk->sn", R,
                                                          alpha)
        else:
            alpha = alpha_flat.cpu().numpy().reshape(st.S, k, n_cols)
            u = (up.cpu().numpy()[:, inv_perm]
                 + np.einsum("snk,skr->snr", R, alpha))
            u = np.moveaxis(u, -1, 0)  # (n_rhs, S, n)
            alpha = np.moveaxis(alpha, -1, 0)  # (n_rhs, S, k)
        nn = prob.n_global_dofs
        lead = () if n_cols is None else (n_cols,)
        acc = np.zeros(lead + (nn,))
        cnt = np.zeros(nn)
        for i, sd in enumerate(prob.subdomains):
            np.add.at(acc, (..., sd.dof_gids), u[..., i, :])
            np.add.at(cnt, sd.dof_gids, 1.0)
        return u, alpha, acc / np.maximum(cnt, 1.0)

    # ---- solution (paper §2.2) ----
    def solve(self, tol: float = 1e-9, max_iter: int = 2000,
              loads: Optional[np.ndarray] = None,
              history: bool = False) -> FetiSolution:
        """One PCPG solve of the problem's own load, or of ``loads`` (a
        host (S, n) stack in original DOF order), the one-case form of
        :meth:`solve_many`.

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
        if loads is None:
            fp = st.fp
            lam0 = coarse.lambda0()
        else:
            f, fp = self._load_stacks(loads)
            lam0 = coarse.lambda0(coarse_e(f, st.R))
        d = ops.dual_rhs(fp)
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

        t0 = time.perf_counter()
        u, alpha, u_global = self._recover(ops, lam, d, fp)
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

    def solve_many(self, loads, tol: float = 1e-9, max_iter: int = 2000,
                   history: bool = False) -> FetiManySolution:
        """Solve a batch of load cases against the preprocessed state.

        Preprocessing (factorization, F̃, S_b) is paid once; the batch runs
        through one block PCPG (:func:`repro_torch.feti.pcpg.pcpg_many`)
        whose operator applications read the stored stacks once a block
        iteration for every column, and each column stops on its own.
        Below f64 in explicit mode the block runs the reduced F̃ to that
        dtype's floor, then block defect-correction outers recover f64
        accuracy as in :meth:`solve`.

        ``loads``: (n_rhs, S, n) host stack of per-subdomain loads in
        original DOF order (one (S, n) case is promoted to a batch of one).
        A batch of one goes through :meth:`solve`. ``history=True`` records
        every column's ‖P r‖ per block trip, without changing ``lam``.
        """
        if self.state is None:
            self.preprocess()
        st = self.state
        prob = self.problem
        fc = self.config
        loads = np.asarray(loads)
        if loads.ndim == 2:
            loads = loads[None]
        S, n = st.S, prob.subdomains[0].n
        if loads.ndim != 3 or loads.shape[1:] != (S, n):
            raise ValueError(f"loads must be (n_rhs, {S}, {n}) (or one "
                             f"(S, n) case), got {loads.shape}")
        n_rhs = loads.shape[0]
        dtypes = dict(storage_dtype=fc.dtype_name,
                      compute_dtype=dtype_name(fc.compute_dtype),
                      solve_dtype=dtype_name(fc.solve_dtype))

        if n_rhs == 1:
            sol = self.solve(tol=tol, max_iter=max_iter, loads=loads[0],
                             history=history)
            self.timings["solve_many_s"] = self.timings["solve_s"]
            self.timings["per_solve_s"] = self.timings["solve_s"]
            return FetiManySolution(
                u=sol.u[None], u_global=sol.u_global[None],
                lam=sol.lam[None], alpha=sol.alpha[None],
                iterations=np.asarray([sol.iterations]),
                residuals=np.asarray([sol.residual]),
                converged=np.asarray([sol.converged]),
                block_iterations=sol.iterations, n_rhs=1,
                timings=dict(self.timings), refine_outer=sol.refine_outer,
                residual_history=(None if sol.residual_history is None
                                  else sol.residual_history[None]),
                **dtypes)

        ops = self._solution_ops()
        coarse = ops.coarse
        t0 = time.perf_counter()
        # column-stacked device layout: (S, n, n_rhs), the case last
        F, Fp = self._load_stacks(loads.transpose(1, 2, 0))
        D = ops.dual_rhs(Fp)
        Lam0 = coarse.lambda0(coarse_e(F, st.R))
        _sync(st.device)
        self.timings["rhs_setup_s"] = time.perf_counter() - t0

        mixed = st.refine_steps > 0 and self.mode == "explicit"
        inner_tol = max(tol, tol_floor(fc.storage_dtype)) if mixed else tol

        def run(rhs, start):
            return pcpg_many(ops.apply_F, coarse.project, rhs, start,
                             precondition=ops.precond, tol=inner_tol,
                             max_iter=max_iter, history=history)

        t0 = time.perf_counter()
        res: PCPGManyResult = run(D, Lam0)
        Lam = res.lam
        iters = res.iterations.copy()
        residuals, converged = res.residual, res.converged
        block_iters = res.block_iterations
        hist_rows = [res.residual_history] if history else []
        n_outer = 0
        if mixed:
            # block defect correction (see solve()): columns already at
            # their target freeze at iteration 0 of a correction solve
            def col_norms(W):
                return torch.linalg.norm(W, dim=0).cpu().numpy()

            W0n = col_norms(coarse.project(D - ops.apply_F(Lam0)))
            targets = tol * np.maximum(W0n, 1e-300)
            R = D - ops.apply_F_exact(Lam)
            Wn = col_norms(coarse.project(R))
            prev = np.full_like(Wn, np.inf)
            while (np.any(Wn > targets) and n_outer < _MAX_OUTER
                   and np.all(Wn <= np.maximum(0.5 * prev, targets))):
                prev = Wn
                cres = run(R, torch.zeros_like(Lam))
                Lam = Lam + cres.lam
                if history:
                    hist_rows.append(cres.residual_history)
                iters += cres.iterations
                block_iters += cres.block_iterations
                n_outer += 1
                R = D - ops.apply_F_exact(Lam)
                Wn = col_norms(coarse.project(R))
            residuals = Wn
            converged = Wn <= targets
        _sync(st.device)
        t_solve = time.perf_counter() - t0
        self.timings["solve_many_s"] = t_solve
        self.timings["per_solve_s"] = t_solve / n_rhs

        t0 = time.perf_counter()
        u, alpha, u_global = self._recover(ops, Lam, D, Fp)
        self.timings["recover_s"] = time.perf_counter() - t0

        return FetiManySolution(
            u=u, u_global=u_global, lam=Lam.cpu().numpy().T, alpha=alpha,
            iterations=iters, residuals=residuals, converged=converged,
            block_iterations=block_iters, n_rhs=n_rhs,
            timings=dict(self.timings), refine_outer=n_outer,
            residual_history=(np.ascontiguousarray(
                np.concatenate(hist_rows).T) if history else None),
            **dtypes)

    def report(self):
        raise NotImplementedError("telemetry (repro.obs) is ROADMAP item A15")


def solve_many(problem: FetiProblem, loads, config=None, *,
               tol: float = 1e-9, max_iter: int = 2000) -> FetiManySolution:
    """Preprocess once and block-solve a batch of load cases: exactly
    ``FetiSolver(problem, config).solve_many(loads, ...)``. Callers that
    stream several batches against one preprocessing hold a
    :class:`FetiSolver` instead."""
    return FetiSolver(problem, config).solve_many(
        loads, tol=tol, max_iter=max_iter)
