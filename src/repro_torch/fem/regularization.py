"""Analytic (fixing-DOF) regularization of the SPSD subdomain matrices
(paper §2.2, [Brzobohatý et al. 2011]); numpy counterpart of
``repro.fem.regularization`` for kernel dimension k ≥ 1.

Pick k fixing DOFs such that the kernel basis restricted to those rows is
invertible, and add ρ to their diagonal entries:

    K_reg = K + ρ Σ_{j ∈ fixing_dofs} e_j e_jᵀ

For any rhs ∈ range(K), ``K_reg⁻¹ rhs`` is then an exact particular
solution, so ``K⁺ := K_reg⁻¹`` is the generalized inverse FETI needs.
Only diagonal entries change, so the sparsity pattern (and the symbolic
factorization) is untouched.

Instances: heat (k = 1, kernel = constants) fixes one node; 2D elasticity
(k = 3) both components of one node plus the y-component of a node at a
different x; 3D elasticity (k = 6) the 3-2-1 locating rule (see
``repro_torch.fem.decomposition._fixing_dofs``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["regularization_shift", "fixing_dofs_regularization",
           "kernel_basis", "rigid_body_modes"]


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


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """Raw (un-orthonormalized) rigid-body modes of a 2D/3D point cloud.

    Returns (n_nodes*d, k) in node-blocked DOF order: d translations plus
    1 (2D) or 3 (3D) infinitesimal rotations about the centroid.
    """
    coords = np.asarray(coords, dtype=np.float64)
    nn, d = coords.shape
    x = coords - coords.mean(axis=0)  # centering only affects conditioning
    k = 3 if d == 2 else 6
    R = np.zeros((nn, d, k), dtype=np.float64)
    for c in range(d):  # translations
        R[:, c, c] = 1.0
    if d == 2:
        R[:, 0, 2] = -x[:, 1]
        R[:, 1, 2] = x[:, 0]
    else:
        R[:, 0, 3] = -x[:, 1]
        R[:, 1, 3] = x[:, 0]
        R[:, 1, 4] = -x[:, 2]
        R[:, 2, 4] = x[:, 1]
        R[:, 0, 5] = x[:, 2]
        R[:, 2, 5] = -x[:, 0]
    return R.reshape(nn * d, k)


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    """QR-orthonormalize columns with a deterministic sign convention
    (each column's largest-magnitude entry is positive)."""
    Q, _ = np.linalg.qr(R)
    for j in range(Q.shape[1]):
        col = Q[:, j]
        if col[np.argmax(np.abs(col))] < 0:
            Q[:, j] = -col
    return Q


def kernel_basis(n: int | None = None, problem: str = "heat",
                 coords: np.ndarray | None = None) -> np.ndarray:
    """Orthonormal basis of Ker(K_i) as an (n, k) column matrix.

    * ``problem="heat"``: the normalized constant, (n, 1); needs ``n``.
    * ``problem="elasticity"``: the rigid-body modes of the subdomain's
      nodes, (n_nodes*d, k) with k = 3 (2D) / 6 (3D); needs ``coords``.

    Both go through the same orthonormalization.
    """
    if problem == "heat":
        if n is None:
            raise ValueError("heat kernel_basis needs n")
        raw = np.ones((n, 1), dtype=np.float64)
    elif problem == "elasticity":
        if coords is None:
            raise ValueError("elasticity kernel_basis needs coords")
        raw = rigid_body_modes(coords)
    else:
        raise ValueError(f"unknown problem {problem!r}")
    return _orthonormalize(raw)
