"""Preconditioned Conjugate Projected Gradient (paper §2.1, [10]);
counterpart of ``repro.feti.pcpg.pcpg``.

The reference's ``lax.while_loop`` becomes a Python loop. Its stopping
test needs ‖w‖ on the host, so each iteration makes exactly one device →
host read (the norm) and no other synchronization; every other quantity
stays on the device. The block multi-RHS ``pcpg_many`` is ROADMAP item A12.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional

import torch

from repro_torch.core.precision import dtype_name, tol_floor

__all__ = ["PCPGResult", "pcpg", "TolClampState", "reset_tol_clamp_warnings"]


class TolClampState:
    """Warn-once state of the tolerance clamp, one per call site, so whether
    a solve warns does not depend on which other solve ran first;
    :func:`reset_tol_clamp_warnings` rearms it."""

    def __init__(self):
        self.warned: set = set()

    def reset(self) -> None:
        self.warned.clear()


_CLAMP_STATE_PCPG = TolClampState()


def reset_tol_clamp_warnings() -> None:
    """Rearm the once-per-dtype tolerance-clamp ``RuntimeWarning``."""
    _CLAMP_STATE_PCPG.reset()


def _clamp_tol(tol: float, dtype, state: TolClampState) -> float:
    """Clamp a requested relative tolerance to what ``dtype`` residual
    arithmetic can attain (:func:`repro_torch.core.precision.tol_floor`),
    warning once per dtype per ``state`` when the clamp engages; f64
    requests above ~1.1e-14 pass through untouched."""
    floor = tol_floor(dtype)
    if tol >= floor:
        return tol
    name = dtype_name(dtype)
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
