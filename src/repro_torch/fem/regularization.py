"""Analytic (fixing-DOF) regularization of the SPSD subdomain matrices
(paper §2.2, [Brzobohatý et al. 2011]); numpy counterpart of
``repro.fem.regularization`` for the heat kernel (k = 1).

Pick k fixing DOFs such that the kernel basis restricted to those rows is
invertible, and add ρ to their diagonal entries:

    K_reg = K + ρ Σ_{j ∈ fixing_dofs} e_j e_jᵀ

For any rhs ∈ range(K), ``K_reg⁻¹ rhs`` is then an exact particular
solution, so ``K⁺ := K_reg⁻¹`` is the generalized inverse FETI needs.
Only diagonal entries change, so the sparsity pattern (and the symbolic
factorization) is untouched. Rigid-body kernels of elasticity are ROADMAP
item A10.
"""
from __future__ import annotations

import numpy as np

__all__ = ["regularization_shift", "fixing_dofs_regularization", "kernel_basis"]


def regularization_shift(K: np.ndarray) -> float:
    """The default ρ: the mean of K's diagonal (as the reference takes it)."""
    return float(np.mean(np.diag(K)))


def fixing_dofs_regularization(K: np.ndarray, fixing_dofs,
                               rho: float | None = None) -> np.ndarray:
    """Return a copy of K + ρ·Σ_j e_j e_jᵀ over the fixing DOFs."""
    fixing_dofs = np.atleast_1d(np.asarray(fixing_dofs, dtype=np.int64))
    if rho is None:
        rho = regularization_shift(K)
    K = np.array(K, copy=True)
    K[fixing_dofs, fixing_dofs] += rho
    return K


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    """QR-orthonormalize columns with a deterministic sign convention
    (each column's largest-magnitude entry is positive)."""
    Q, _ = np.linalg.qr(R)
    for j in range(Q.shape[1]):
        col = Q[:, j]
        if col[np.argmax(np.abs(col))] < 0:
            Q[:, j] = -col
    return Q


def kernel_basis(n: int, problem: str = "heat") -> np.ndarray:
    """Orthonormal basis of Ker(K_i) as an (n, k) column matrix: the
    normalized constant (n, 1) for heat."""
    if problem == "elasticity":
        raise NotImplementedError(
            "elasticity kernels (rigid-body modes) are ROADMAP item A10")
    if problem != "heat":
        raise ValueError(f"unknown problem {problem!r}")
    return _orthonormalize(np.ones((n, 1), dtype=np.float64))
