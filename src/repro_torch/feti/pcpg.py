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
from typing import Callable, Optional

import torch

__all__ = ["PCPGResult", "pcpg", "tol_floor"]


def tol_floor(dtype: torch.dtype, factor: float = 50.0) -> float:
    """The smallest relative tolerance worth asking of an operator in
    ``dtype``: ``factor * eps`` (f64: ~1.1e-14)."""
    return factor * torch.finfo(dtype).eps


def _clamp_tol(tol: float, dtype: torch.dtype) -> float:
    """Clamp a requested relative tolerance to what ``dtype`` residual
    arithmetic can attain, warning when the clamp engages; f64 requests
    above ~1.1e-14 pass through untouched."""
    floor = tol_floor(dtype)
    if tol >= floor:
        return tol
    warnings.warn(f"PCPG tol={tol:g} is below the attainable floor {floor:g} "
                  f"for {dtype} residual arithmetic; clamping.",
                  RuntimeWarning, stacklevel=3)
    return floor


def _safe_denom(x: torch.Tensor) -> torch.Tensor:
    """Sign-preserving denominator guard: |x| floored at the dtype's
    smallest normal (unchanged for every normal value)."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny,
                       torch.where(x < 0, -tiny, tiny).to(x.dtype), x)


@dataclasses.dataclass
class PCPGResult:
    lam: torch.Tensor
    iterations: int
    residual: float  # final ||P r||
    converged: bool


def pcpg(
    apply_F: Callable[[torch.Tensor], torch.Tensor],
    project: Callable[[torch.Tensor], torch.Tensor],
    d: torch.Tensor,
    lam0: torch.Tensor,
    precondition: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-9,
    max_iter: int = 500,
) -> PCPGResult:
    """Solve P F λ = P d on the affine space λ⁰ + Ker(Gᵀ).

    Iterates:  w = P r;  z = P M⁻¹ w;  standard CG update with (z·w) inner
    products. Without a preconditioner z = w (M = I). Stops when
    ‖w‖ ≤ tol·‖w⁰‖ or after ``max_iter`` iterations.
    """
    if precondition is None:
        def precondition(x):
            return x
    tol = _clamp_tol(tol, d.dtype)

    lam = lam0
    r = d - apply_F(lam0)
    w = project(r)
    p = project(precondition(w))
    zeta = torch.dot(p, w)
    w_norm = float(torch.linalg.norm(w))
    atol = tol * max(w_norm, 1e-30)
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
        k += 1
    return PCPGResult(lam=lam, iterations=k, residual=w_norm,
                      converged=w_norm <= atol)
