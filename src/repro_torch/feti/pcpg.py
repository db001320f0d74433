"""Preconditioned Conjugate Projected Gradient (paper §2.1, [10]);
counterpart of ``repro.feti.pcpg.pcpg``.

The reference's ``lax.while_loop`` becomes a Python loop. Its stopping
test needs ‖w‖ on the host, so each iteration makes exactly one device →
host read (the norm, or in the block ``pcpg_many`` the per-column norms)
and no other synchronization; every other quantity stays on the device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.precision import dtype_name, tol_floor
from repro_torch.obs import metrics

__all__ = ["PCPGResult", "PCPGManyResult", "pcpg", "pcpg_many",
           "TolClampState", "reset_tol_clamp_warnings"]


class TolClampState:
    """Warn-once state of the tolerance clamp, one per call site, so whether
    a solve warns does not depend on which other solve ran first;
    :func:`reset_tol_clamp_warnings` rearms it."""

    def __init__(self):
        self.warned: set = set()

    def reset(self) -> None:
        self.warned.clear()


_CLAMP_STATE_PCPG = TolClampState()
_CLAMP_STATE_PCPG_MANY = TolClampState()


def reset_tol_clamp_warnings() -> None:
    """Rearm the once-per-dtype tolerance-clamp ``RuntimeWarning`` at both
    call sites (:func:`pcpg` and :func:`pcpg_many`)."""
    _CLAMP_STATE_PCPG.reset()
    _CLAMP_STATE_PCPG_MANY.reset()


def _clamp_tol(tol: float, dtype, state: TolClampState) -> float:
    """Clamp a requested relative tolerance to what ``dtype`` residual
    arithmetic can attain (:func:`repro_torch.core.precision.tol_floor`),
    warning once per dtype per ``state`` when the clamp engages; f64
    requests above ~1.1e-14 pass through untouched.

    Every engagement increments the ``pcpg.tol_clamp`` telemetry counter
    (exact, independent of the warn-once dedup). The port runs eagerly, so
    the counter counts clamped *calls*; the reference clamps at trace time
    and counts clamped compilations (call sites) instead."""
    floor = tol_floor(dtype)
    if tol >= floor:
        return tol
    name = dtype_name(dtype)
    metrics.inc("pcpg.tol_clamp", dtype=name)
    if name not in state.warned:
        state.warned.add(name)
        warnings.warn(
            f"PCPG tol={tol:g} is below the attainable floor {floor:g} for "
            f"{name} residual arithmetic; clamping. Use refinement "
            f"(FetiConfig.refine) for f64 accuracy on reduced-precision "
            f"operators.", RuntimeWarning, stacklevel=3)
    return floor


def _safe_denom(x: torch.Tensor) -> torch.Tensor:
    """Sign-preserving denominator guard: |x| floored at the dtype's
    smallest normal (unchanged for every normal value), so an f32 p·Fp or
    ζ that flushed to zero never divides."""
    tiny = torch.finfo(x.dtype).tiny
    floor = torch.full_like(x, tiny)  # at x's dtype: f64's tiny is no f32
    return torch.where(x.abs() < tiny, torch.where(x < 0, -floor, floor), x)


@dataclasses.dataclass
class PCPGResult:
    lam: torch.Tensor
    iterations: int
    residual: float  # final ||P r||
    converged: bool
    # per-iteration ||P r|| (iteration k at index k) when history was
    # requested, else None
    residual_history: Optional[List[float]] = None


@dataclasses.dataclass
class PCPGManyResult:
    lam: torch.Tensor  # (n_lambda, n_rhs) multiplier stack
    iterations: np.ndarray  # (n_rhs,) per-column iteration counts
    residual: np.ndarray  # (n_rhs,) final per-column ||P r||
    converged: np.ndarray  # (n_rhs,) bool
    block_iterations: int  # loop trips run (the most of ``iterations``)
    # (block_iterations, n_rhs) per-trip ||P r|| per column when history was
    # requested (frozen columns repeat their converged value), else None
    residual_history: Optional[np.ndarray] = None


def pcpg(
    apply_F: Callable[[torch.Tensor], torch.Tensor],
    project: Callable[[torch.Tensor], torch.Tensor],
    d: torch.Tensor,
    lam0: torch.Tensor,
    precondition: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-9,
    max_iter: int = 500,
    history: bool = False,
) -> PCPGResult:
    """Solve P F λ = P d on the affine space λ⁰ + Ker(Gᵀ).

    Iterates:  w = P r;  z = P M⁻¹ w;  standard CG update with (z·w) inner
    products. Without a preconditioner z = w (M = I). Stops when
    ‖w‖ ≤ tol·‖w⁰‖ or after ``max_iter`` iterations; ``tol`` is first
    clamped to the floor of ``d``'s dtype.

    ``history=True`` records ‖P r‖ after every iteration (the host value
    the stopping test reads anyway), so ``residual_history[iterations - 1]
    == residual``; the recurrence is the same operations, and ``lam`` is
    bit-identical to the ``history=False`` run.
    """
    if precondition is None:
        def precondition(x):
            return x
    tol = _clamp_tol(tol, d.dtype, _CLAMP_STATE_PCPG)

    lam = lam0
    r = d - apply_F(lam0)
    w = project(r)
    p = project(precondition(w))
    zeta = torch.dot(p, w)
    w_norm = float(torch.linalg.norm(w))
    atol = tol * max(w_norm, 1e-30)
    trace = [] if history else None
    k = 0
    while k < max_iter and w_norm > atol:
        Fp = apply_F(p)
        gamma = zeta / _safe_denom(torch.dot(p, Fp))
        lam = lam + gamma * p
        r = r - gamma * Fp
        w = project(r)
        z = project(precondition(w))
        zeta_new = torch.dot(z, w)
        beta = zeta_new / _safe_denom(zeta)
        p = z + beta * p
        zeta = zeta_new
        w_norm = float(torch.linalg.norm(w))  # the iteration's one host read
        if trace is not None:
            trace.append(w_norm)
        k += 1
    return PCPGResult(lam=lam, iterations=k, residual=w_norm,
                      converged=w_norm <= atol, residual_history=trace)


def pcpg_many(
    apply_F: Callable[[torch.Tensor], torch.Tensor],
    project: Callable[[torch.Tensor], torch.Tensor],
    D: torch.Tensor,
    Lam0: torch.Tensor,
    precondition: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-9,
    max_iter: int = 500,
    history: bool = False,
) -> PCPGManyResult:
    """Block PCPG over an (n_lambda, n_rhs) multiplier stack with
    per-column stopping.

    Each column runs :func:`pcpg`'s iteration on its own (d_j, λ⁰_j): inner
    products, step lengths and stopping tests are per column (reductions
    over the λ axis only), so no column's trajectory depends on its
    neighbours'. The operators see the whole stack at once, so the stored
    stacks are read once a block iteration for every column.

    A converged column is frozen in place: its step lengths are zero (on a
    safe denominator, so nothing non-finite leaks), its λ, r and p stop
    changing and its residual and count keep their converged values. The
    loop ends when every column is frozen or after ``max_iter`` trips;
    columns converged at the start (a zero load) never iterate. Each trip
    reads the per-column ‖P r‖ to the host once. ``history=True`` records
    them after every trip (column j's curve is
    ``residual_history[:iterations[j], j]``); ``lam`` is bit-identical to
    the ``history=False`` run.
    """
    if precondition is None:
        def precondition(x):
            return x
    tol = _clamp_tol(tol, D.dtype, _CLAMP_STATE_PCPG_MANY)

    def col_dot(a, b):
        return (a * b).sum(dim=0)  # (n_rhs,) per-column inner products

    def col_norm(a):
        return (a * a).sum(dim=0).sqrt()

    one = torch.ones((), dtype=D.dtype, device=D.device)
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    Lam = Lam0
    R = D - apply_F(Lam0)
    W = project(R)
    Pm = project(precondition(W))
    zeta = col_dot(Pm, W)
    w_norm = col_norm(W)
    w_host = w_norm.cpu().numpy()
    atol = tol * np.maximum(w_host, 1e-30)
    active_host = w_host > atol
    active = torch.as_tensor(active_host, device=D.device)
    iters = np.zeros(D.shape[1], dtype=np.int64)
    trace = [] if history else None
    k = 0
    while k < max_iter and active_host.any():
        FP = apply_F(Pm)
        gamma = torch.where(
            active, zeta / _safe_denom(torch.where(active, col_dot(Pm, FP),
                                                   one)), zero)
        Lam = Lam + gamma * Pm
        R = R - gamma * FP
        # a frozen column's R is unchanged, and so are its W, Z and ζ
        W = project(R)
        Z = project(precondition(W))
        zeta_new = col_dot(Z, W)
        beta = torch.where(
            active, zeta_new / _safe_denom(torch.where(active, zeta, one)),
            zero)
        Pm = torch.where(active, Z + beta * Pm, Pm)
        zeta = torch.where(active, zeta_new, zeta)
        w_norm = torch.where(active, col_norm(W), w_norm)
        iters += active_host
        w_host = w_norm.cpu().numpy()  # the trip's one host read
        active_host = active_host & (w_host > atol)
        active = torch.as_tensor(active_host, device=D.device)
        if trace is not None:
            trace.append(w_host)
        k += 1
    return PCPGManyResult(
        lam=Lam, iterations=iters, residual=w_host,
        converged=w_host <= atol, block_iterations=k,
        residual_history=(np.stack(trace) if trace else
                          np.zeros((0, D.shape[1]))) if history else None)
