"""End-to-end FETI solver (paper §2 + §5); counterpart of
``repro.feti.solver`` for one device or, under ``FetiConfig.mesh``, one
rank of the subdomain-sharded pipeline (:mod:`repro_torch.feti.sharded`),
one load case (``solve``) or a batch of them through the block PCPG
(``solve_many``), at f64 or with reduced-precision stacks (f32, bf16) and
refinement.

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

Telemetry (paper §5's measurements): every phase opens a span on the
solver's :class:`~repro_torch.obs.Telemetry` tracer — ``preprocess`` (with
``init``, ``prep`` and its ``stage:*`` children, ``pack`` from
:func:`~repro_torch.feti.assembly.preprocess_cluster`), and per solve
``solve`` with ``rhs_setup``, ``pcpg`` (``refine_outer`` beside it under
mixed precision) and ``recover`` — each closing after a device
synchronization, so it measures the device work, not its enqueue. The
PCPG counters and the device-byte gauges go to the process-global
:mod:`repro_torch.obs.metrics`; :meth:`FetiSolver.report` returns both,
and :meth:`FetiSolver.amortization_report` turns the spans into the
paper's break-even iteration count. ``timings`` stays as the deprecated
flat view (host wall clock around the same synchronized work).

Under a mesh every rank preprocesses its own subdomains, the λ-space
operators and the coarse problem are the sharded ones (each λ-space sum an
all-reduce), and the recovered u is assembled from every rank's
subdomains, so every rank returns the same solution. Spans, ``timings``,
``report()`` and the device bytes stay per rank; the ``pcpg`` span also
carries the rank's ``all_reduces`` there. PCPG needs no change: λ is whole
on every rank and every value it stops on comes out of an all-reduce.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import Plan, SchurAssemblyConfig, assembly_flops
from repro_torch.core.precision import dtype_name, itemsize, tol_floor
from repro_torch.fem.decomposition import FetiProblem
from repro_torch.feti import sharded
from repro_torch.feti.assembly import ClusterState, preprocess_cluster
from repro_torch.feti.config import as_feti_config
from repro_torch.feti.operator import (
    batched_apply,
    dirichlet_preconditioner,
    _minus_c,
    dual_load,
    dual_load_refined,
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
from repro_torch.launch.analytic import feti_solve_iter_counts
from repro_torch.obs import Telemetry, metrics
from repro_torch.obs.trace import use_tracer
from repro_torch.sparse import PackedBlocks
from repro_torch.sparse.cholesky import block_cholesky_flops

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
    coarse_e: Callable  # f (S, n[, r]) -> e = Rᵀf (S_total·k[, r])


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
        # structured telemetry (spans + metrics), on by default: a span
        # costs two clock reads and a synchronization the surrounding code
        # needs anyway; telemetry.disable() makes the spans no-ops
        self.telemetry = Telemetry()
        self.timings: dict = {}  # deprecated flat view; prefer report()
        self._ops: Optional[_SolutionOps] = None

    # ---- preprocessing (paper §2.2) ----
    def preprocess(self) -> ClusterState:
        # no f32 product on the path may round through TF32 (10-bit
        # mantissa): the f32 stacks and the kernels' plain versions run in
        # full f32, as the reference's do
        torch.backends.cuda.matmul.allow_tf32 = False
        tr = self.telemetry.tracer
        t0 = time.perf_counter()
        with use_tracer(tr), tr.span("preprocess") as sp:
            self.state = preprocess_cluster(self.problem, self.config)
            # an explicit sync (not only the span's): the timings entry
            # must stay honest when telemetry is disabled
            _sync(self.state.device)
            sp.set(mode=self.mode, S=int(self.state.S))
        self.cfg = self.state.cfg  # resolved when "auto" was passed
        self.plan = self.state.plan
        self._ops = None
        self.timings["preprocess_s"] = time.perf_counter() - t0
        self._record_device_bytes()
        return self.state

    def _record_device_bytes(self) -> None:
        """Gauge the persistent device stacks: bytes per stack labeled by
        dtype, per stage-graph node, and the total."""
        st = self.state
        db = st.device_bytes()
        stacks = {"L": st.L, "K": st.K, "Btp": st.Btp, "F": st.F,
                  "Sb": st.Sb, "Btb": st.Btb, "Kreg": st.Kreg}
        for name, x in stacks.items():
            if x is None:
                continue
            # packed stacks carry their dtype on .values; the label is the
            # reference's numpy name ("float64", "float32", "bfloat16")
            dt = (x.values if isinstance(x, PackedBlocks) else x).dtype
            metrics.gauge("device_bytes", int(db[name]), stack=name,
                          dtype=str(dt).removeprefix("torch."))
        metrics.gauge("device_bytes_total", int(db["total"]))
        for stage, v in db["per_stage"].items():
            metrics.gauge("device_bytes", int(v), stage=stage)

    # ---- solution-phase machinery, load-independent ----
    def _solution_ops(self) -> _SolutionOps:
        if self._ops is not None:
            return self._ops
        st = self.state
        prob = self.problem
        mesh = st.mesh
        vdt = self.config.solve_dtype  # f64 when refining, else storage
        stor = self.config.storage_dtype
        refine = st.refine_steps
        Bt_orig = torch.as_tensor(
            np.stack([prob.subdomains[i].Bt for i in st.owned]),
            dtype=vdt, device=st.device)
        c = torch.as_tensor(prob.c, dtype=vdt, device=st.device)
        if mesh is None:
            coarse = build_coarse_problem(Bt_orig, st.f, st.R, st.dual)
            load_moment = partial(coarse_e, R=st.R)

            def reduced(fn):
                return fn
        else:
            S = prob.n_subdomains
            coarse = sharded.build_coarse_problem(
                mesh, Bt_orig, st.f, st.R, st.dual, st.owned, S)
            load_moment = partial(sharded.coarse_e, mesh, R=st.R,
                                  owned=st.owned, S=S)

            def reduced(fn):
                return sharded.reduce_sum(mesh, fn)
        # B̃ᵀ at the solve dtype, cast once (exact: it holds ±1 and 0); the
        # stored stack itself when that is its dtype
        Bt = st.Btp.to(vdt)
        if self.mode == "explicit":
            apply_F = reduced(partial(explicit_dual_apply, st.F, st.dual))
        elif refine > 0:
            # the refined implicit operator is f64-accurate by itself, so
            # plain PCPG reaches f64 tolerances with it
            apply_F = reduced(partial(implicit_dual_apply_refined, st.L,
                                      st.Kreg, Bt, st.dual, refine))
        else:
            apply_F = reduced(partial(implicit_dual_apply, st.L, st.Btp,
                                      st.dual))
        if refine > 0:
            apply_F_exact = reduced(partial(implicit_dual_apply_refined,
                                            st.L, st.Kreg, Bt, st.dual,
                                            refine))
            load = partial(dual_load_refined, st.L, st.Kreg, Bt, dm=st.dual,
                           steps=refine)
        else:
            apply_F_exact = apply_F
            load = partial(dual_load, st.L, st.Btp, dm=st.dual)
        # d = B K⁺ f − c: c once, after the ranks' loads are summed
        load = reduced(load)
        if self.preconditioner == "lumped":
            # K is packed in factor row order, so it pairs with Btp (the
            # product B̃ K B̃ᵀ is invariant to the shared row permutation)
            precond = reduced(partial(lumped_preconditioner, st.K, st.Btp,
                                      st.dual))
        elif self.preconditioner == "dirichlet":
            if st.Sb is None:
                raise ValueError(
                    "state was preprocessed without the dirichlet stage; "
                    "construct the solver with preconditioner='dirichlet' "
                    "before preprocess()")
            precond = reduced(partial(dirichlet_preconditioner, st.Sb,
                                      st.Btb, st.dual))
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
            precond=precond, dual_rhs=lambda fp: _minus_c(load(fp=fp), c),
            Bt=Bt, coarse_e=load_moment)
        return self._ops

    def _load_stacks(self, loads: np.ndarray):
        """Host (S, n, ...) loads in original DOF order -> device (f, fp)
        at the solve dtype, fp in factor row order (this rank's subdomains
        under a mesh)."""
        st = self.state
        own = st.owned
        f = torch.as_tensor(np.asarray(loads)[own.start:own.stop],
                            dtype=self.config.solve_dtype, device=st.device)
        return f, f[:, torch.as_tensor(st.node_perm, device=st.device)]

    def _recover(self, ops: _SolutionOps, lam: torch.Tensor,
                   d: torch.Tensor, fp: torch.Tensor):
        """α (paper eq. 7) and u = K⁺(f − Bᵀλ) + Rα (eq. 5), back to
        original DOF order and averaged onto the global mesh (host numpy).
        An (n_lambda, n_rhs) ``lam`` recovers that many stacked columns,
        the load case leading. Under a mesh each rank solves for its own
        subdomains and the (S, n[, n_rhs]) stack is assembled from every
        rank's, so every rank returns the whole solution."""
        st = self.state
        prob = self.problem
        alpha_flat = ops.coarse.alpha(ops.apply_F_exact(lam) - d)  # (S·k,..)
        rhs = fp - batched_apply(ops.Bt, gather_local(lam, st.dual))
        if st.refine_steps > 0:
            up = solve_with_factor_refined(st.L, st.Kreg, rhs,
                                           st.refine_steps)
        else:
            up = solve_with_factor(st.L, rhs)
        S = prob.n_subdomains
        k = st.R.shape[2]
        if st.mesh is None:
            R = st.R.cpu().numpy()
        else:
            up = sharded.assemble_segments(st.mesh, up, st.owned.start, S)
            R = torch.as_tensor(np.stack([sd.R for sd in prob.subdomains]),
                                dtype=st.R.dtype).numpy()
        n_cols = lam.shape[1] if lam.dim() == 2 else None
        inv_perm = np.argsort(st.node_perm)
        if n_cols is None:
            alpha = alpha_flat.cpu().numpy().reshape(S, k)
            u = up.cpu().numpy()[:, inv_perm] + np.einsum("snk,sk->sn", R,
                                                          alpha)
        else:
            alpha = alpha_flat.cpu().numpy().reshape(S, k, n_cols)
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

    def _all_reduces(self) -> int:
        mesh = self.state.mesh
        return 0 if mesh is None else mesh.all_reduces

    def _set_all_reduces(self, span, before: int) -> None:
        """Under a mesh, the all-reduces this rank made since ``before`` on
        ``span`` (six a PCPG iteration with a preconditioner, six more for
        its start)."""
        if self.state.mesh is not None:
            span.set(all_reduces=self._all_reduces() - before)

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

        tr = self.telemetry.tracer
        with use_tracer(tr), tr.span("solve", mode=self.mode) as sp_solve:
            t0 = time.perf_counter()
            with tr.span("rhs_setup") as sp:
                if loads is None:
                    fp = st.fp
                    lam0 = coarse.lambda0()
                else:
                    f, fp = self._load_stacks(loads)
                    lam0 = coarse.lambda0(ops.coarse_e(f))
                d = ops.dual_rhs(fp)
                sp.sync(d, lam0)
                _sync(st.device)
            self.timings["rhs_setup_s"] = time.perf_counter() - t0

            # mixed precision, explicit mode: the inner PCPG runs the
            # reduced F̃ down to its dtype's floor, then the outers recover
            # f64
            mixed = st.refine_steps > 0 and self.mode == "explicit"
            inner_tol = (max(tol, tol_floor(fc.storage_dtype)) if mixed
                         else tol)

            def run(rhs, start):
                return pcpg(ops.apply_F, coarse.project, rhs, start,
                            precondition=ops.precond, tol=inner_tol,
                            max_iter=max_iter, history=history)

            t0 = time.perf_counter()
            with tr.span("pcpg", tol=float(inner_tol)) as sp:
                reduces = self._all_reduces()
                res: PCPGResult = run(d, lam0)
                sp.sync(res.lam)
                sp.set(iterations=int(res.iterations),
                       residual=float(res.residual))
                self._set_all_reduces(sp, reduces)
            lam = res.lam
            iterations, residual, converged = (res.iterations, res.residual,
                                               res.converged)
            hist = list(res.residual_history or ())
            n_outer = 0
            if mixed:
                # the target scale is pcpg's: tol · ‖P(d − F λ⁰)‖ (the fast
                # operator is accurate enough to set a scale)
                w0n = float(torch.linalg.norm(
                    coarse.project(d - ops.apply_F(lam0))))
                target = tol * max(w0n, 1e-300)
                r = d - ops.apply_F_exact(lam)
                wnorm = float(torch.linalg.norm(coarse.project(r)))
                prev = float("inf")
                while (wnorm > target and n_outer < _MAX_OUTER
                       and wnorm < 0.5 * prev):
                    prev = wnorm
                    with tr.span("refine_outer", outer=n_outer) as sp:
                        cres = run(r, torch.zeros_like(lam))
                        lam = lam + cres.lam
                        sp.sync(lam)
                        sp.set(iterations=int(cres.iterations))
                    hist += cres.residual_history or ()
                    iterations += cres.iterations
                    n_outer += 1
                    r = d - ops.apply_F_exact(lam)
                    wnorm = float(torch.linalg.norm(coarse.project(r)))
                residual = wnorm
                converged = wnorm <= target
            _sync(st.device)
            self.timings["solve_s"] = time.perf_counter() - t0
            metrics.inc("pcpg.solves")
            metrics.inc("pcpg.iterations", iterations)
            if n_outer:
                metrics.inc("pcpg.refine_outer", n_outer)

            t0 = time.perf_counter()
            with tr.span("recover"):
                # ends in host arrays: synchronized by the copies
                u, alpha, u_global = self._recover(ops, lam, d, fp)
            self.timings["recover_s"] = time.perf_counter() - t0
            if history:
                sp_solve.set(iterations=iterations,
                             residual_history=[float(x) for x in hist])

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
        S, n = prob.n_subdomains, prob.subdomains[0].n
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
        tr = self.telemetry.tracer
        with use_tracer(tr), tr.span("solve", mode=self.mode,
                                     n_rhs=int(n_rhs)) as sp_solve:
            t0 = time.perf_counter()
            with tr.span("rhs_setup") as sp:
                # column-stacked device layout: (S, n, n_rhs), case last
                F, Fp = self._load_stacks(loads.transpose(1, 2, 0))
                D = ops.dual_rhs(Fp)
                Lam0 = coarse.lambda0(ops.coarse_e(F))
                sp.sync(D, Lam0)
                _sync(st.device)
            self.timings["rhs_setup_s"] = time.perf_counter() - t0

            mixed = st.refine_steps > 0 and self.mode == "explicit"
            inner_tol = (max(tol, tol_floor(fc.storage_dtype)) if mixed
                         else tol)

            def run(rhs, start):
                return pcpg_many(ops.apply_F, coarse.project, rhs, start,
                                 precondition=ops.precond, tol=inner_tol,
                                 max_iter=max_iter, history=history)

            t0 = time.perf_counter()
            with tr.span("pcpg", tol=float(inner_tol)) as sp:
                reduces = self._all_reduces()
                res: PCPGManyResult = run(D, Lam0)
                sp.sync(res.lam)
                sp.set(block_iterations=int(res.block_iterations))
                self._set_all_reduces(sp, reduces)
            Lam = res.lam
            iters = res.iterations.copy()
            residuals, converged = res.residual, res.converged
            block_iters = res.block_iterations
            hist_rows = [res.residual_history] if history else []
            n_outer = 0
            if mixed:
                # block defect correction (see solve()): columns already
                # at their target freeze at iteration 0 of a correction
                # solve
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
                    with tr.span("refine_outer", outer=n_outer) as sp:
                        cres = run(R, torch.zeros_like(Lam))
                        Lam = Lam + cres.lam
                        sp.sync(Lam)
                        sp.set(block_iterations=int(cres.block_iterations))
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
            metrics.inc("pcpg.solves", n_rhs)
            metrics.inc("pcpg.iterations", int(iters.sum()))
            if n_outer:
                metrics.inc("pcpg.refine_outer", n_outer)

            t0 = time.perf_counter()
            with tr.span("recover"):
                u, alpha, u_global = self._recover(ops, Lam, D, Fp)
            self.timings["recover_s"] = time.perf_counter() - t0
            if history:
                sp_solve.set(block_iterations=block_iters)

        return FetiManySolution(
            u=u, u_global=u_global, lam=Lam.cpu().numpy().T, alpha=alpha,
            iterations=iters, residuals=residuals, converged=converged,
            block_iterations=block_iters, n_rhs=n_rhs,
            timings=dict(self.timings), refine_outer=n_outer,
            residual_history=(np.ascontiguousarray(
                np.concatenate(hist_rows).T) if history else None),
            **dtypes)

    # ---- telemetry surfacing ----
    def report(self) -> dict:
        """Structured telemetry report for this solver: the nested span
        tree (device-synchronized wall times for every pipeline phase),
        the metrics snapshot (plan-cache hits and misses, PCPG iterations,
        tolerance clamps, device bytes), and the per-stack device bytes.
        ``timings`` is kept as a deprecated flat view: prefer the spans,
        which attribute time instead of overwriting it per call."""
        rep = {
            "schema_version": 1,
            "spans": self.telemetry.tracer.tree(),
            "metrics": metrics.snapshot(),
            "timings": dict(self.timings),  # deprecated: use spans
        }
        if self.state is not None:
            rep["device_bytes"] = self.state.device_bytes()
        return rep

    # ---- amortization (paper §5, Fig. 10) ----
    def amortization_report(self,
                            t_assembly_s: Optional[float] = None,
                            t_implicit_iter_s: Optional[float] = None,
                            t_explicit_iter_s: Optional[float] = None,
                            t_dirichlet_s: Optional[float] = None,
                            n_rhs: int = 1,
                            iters_per_solve: Optional[float] = None) -> dict:
        """Iterations needed before the explicit approach wins (paper §1).

        Every timing argument is optional: when omitted it is filled from
        this solver's spans — ``t_assembly_s`` from the last ``stage:dual``
        span (the factorization plus the dual assembly, as in the
        reference; falling back to the autotuner's measured micro-run
        scaled by S), ``t_dirichlet_s`` from the last ``stage:dirichlet``
        span (else 0), and the CURRENT mode's per-iteration time from the
        last ``pcpg`` span divided by its iteration count. The counterpart
        mode's per-iteration time cannot be inferred from this solver's
        own spans and must be passed; a ``ValueError`` names whatever is
        still missing. The returned dict records where each inferred
        number came from under ``"measured_from"``.

        ``t_dirichlet_s`` (the Dirichlet stage's extra preprocessing) goes
        into the numerator: the stage pays for itself through fewer
        iterations, but its time still delays the explicit operator's
        break-even point.

        With ``n_rhs`` > 1 the iteration times are block iteration times
        on an (n_lambda, n_rhs) stack, so ``amortization_iterations`` stays
        the block-iteration break-even; ``iters_per_solve`` (one load
        case's typical PCPG iteration count) adds ``amortization_solves``,
        the load cases after which explicit assembly has paid for itself.
        The analytic per-iteration cost model
        (:func:`repro_torch.launch.analytic.feti_solve_iter_counts`) is
        attached per n_rhs.
        """
        tr = self.telemetry.tracer
        st = self.state
        measured_from = {}
        if t_assembly_s is None:
            sp = tr.last("stage:dual")
            if sp is not None:
                t_assembly_s = sp.duration
                measured_from["assembly_s"] = "span:stage:dual"
            elif (self.plan is not None and self.plan.measured_s is not None
                  and st is not None):
                t_assembly_s = self.plan.measured_s * st.S
                measured_from["assembly_s"] = "plan.measured_s * S_real"
        if t_dirichlet_s is None:
            sp = tr.last("stage:dirichlet")
            if sp is not None:
                t_dirichlet_s = sp.duration
                measured_from["dirichlet_s"] = "span:stage:dirichlet"
            else:
                t_dirichlet_s = 0.0
        if t_implicit_iter_s is None or t_explicit_iter_s is None:
            sp = tr.last("pcpg")
            iters = None
            if sp is not None:
                iters = sp.attrs.get("iterations",
                                     sp.attrs.get("block_iterations"))
            if iters:
                per_iter = sp.duration / iters
                if self.mode == "implicit" and t_implicit_iter_s is None:
                    t_implicit_iter_s = per_iter
                    measured_from["implicit_iter_s"] = "span:pcpg"
                elif self.mode == "explicit" and t_explicit_iter_s is None:
                    t_explicit_iter_s = per_iter
                    measured_from["explicit_iter_s"] = "span:pcpg"
        missing = [nm for nm, v in (("t_assembly_s", t_assembly_s),
                                    ("t_implicit_iter_s", t_implicit_iter_s),
                                    ("t_explicit_iter_s", t_explicit_iter_s))
                   if v is None]
        if missing:
            raise ValueError(
                "amortization_report could not infer "
                + ", ".join(missing) + " from telemetry spans; pass "
                "explicitly (the counterpart mode's per-iteration time "
                "always must be — this solver only ever measures its own "
                "mode)")
        gain = t_implicit_iter_s - t_explicit_iter_s
        overhead = t_assembly_s + t_dirichlet_s
        point = float("inf") if gain <= 0 else overhead / gain
        amort_solves = None
        if iters_per_solve is not None and iters_per_solve > 0:
            amort_solves = point / iters_per_solve * n_rhs
        iter_counts = flops = d_flops = None
        if st is not None:
            iter_counts = feti_solve_iter_counts(
                st.S, self.problem.m_max, n_rhs=n_rhs,
                fb=itemsize(self.config.dtype_name))
            flops = assembly_flops(st.env, self.cfg)
        if st is not None and st.dirichlet_env is not None:
            d_flops = dict(assembly_flops(st.dirichlet_env, st.dirichlet_cfg))
            chol_ii = block_cholesky_flops(
                st.split.n_i, st.dirichlet_cfg.block_size, st.dirichlet_mask)
            # a shared interior factor elides the interior factorization:
            # the dual factor already holds it
            d_flops["cholesky_ii"] = 0.0 if st.shared_factor else chol_ii
            d_flops["cholesky_ii_saved_by_sharing"] = (
                chol_ii if st.shared_factor else 0.0)
            d_flops["total"] += d_flops["cholesky_ii"]
        return {
            "amortization_iterations": point,
            "amortization_solves": amort_solves,
            "n_rhs": int(n_rhs),
            "assembly_s": t_assembly_s,
            "dirichlet_s": t_dirichlet_s,
            "implicit_iter_s": t_implicit_iter_s,
            "explicit_iter_s": t_explicit_iter_s,
            "assembly_flops_per_subdomain": flops,
            "dirichlet_flops_per_subdomain": d_flops,
            "solve_iter_counts": iter_counts,
            "measured_from": measured_from,
        }


def solve_many(problem: FetiProblem, loads, config=None, *,
               tol: float = 1e-9, max_iter: int = 2000) -> FetiManySolution:
    """Preprocess once and block-solve a batch of load cases: exactly
    ``FetiSolver(problem, config).solve_many(loads, ...)``. Callers that
    stream several batches against one preprocessing hold a
    :class:`FetiSolver` instead."""
    return FetiSolver(problem, config).solve_many(
        loads, tol=tol, max_iter=max_iter)
