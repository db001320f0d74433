"""P1 finite-element assembly for the scalar heat-transfer (Laplace)
problem, in numpy (counterpart of ``repro.fem.assembly``, heat only).

Element stiffness is vectorized over elements; the dense scatter builds
the per-subdomain matrices, the scipy CSR path is the reference oracle for
validating the FETI solve against an undecomposed global solve. Vector
elasticity is ROADMAP item A10.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sps

__all__ = [
    "p1_element_stiffness",
    "load_vector",
    "assemble_dense",
    "assemble_scipy_csr",
]


def _element_geometry(coords, elems):
    """Per-element edge matrices ``D[:, :, j-1] = p_j - p_0`` and volumes."""
    coords = np.asarray(coords, dtype=np.float64)
    p = coords[np.asarray(elems)]  # (ne, d+1, d)
    d = coords.shape[1]
    D = np.swapaxes(p[:, 1:, :] - p[:, :1, :], 1, 2)  # (ne, d, d)
    vol = np.abs(np.linalg.det(D)) / math.factorial(d)
    return D, vol


def _p1_gradients(coords, elems):
    """Barycentric shape-function gradients and volumes, per element.

    For a simplex with vertices p0..pd, ``g_j = rows of inv(D)`` for j>=1
    (``D[:, j-1] = p_j - p_0``) and ``g_0 = -sum_j g_j``.

    Returns ``(G, vol)`` with G: (n_elems, d+1, d) and vol: (n_elems,).
    """
    D, vol = _element_geometry(coords, elems)
    g_rest = np.linalg.inv(D)  # (ne, d, d); rows are g_1..g_d
    g0 = -np.sum(g_rest, axis=1, keepdims=True)  # (ne, 1, d)
    return np.concatenate([g0, g_rest], axis=1), vol


def p1_element_stiffness(coords, elems, kappa: float = 1.0) -> np.ndarray:
    """Per-element P1 heat stiffness ``Ke = kappa * vol * G Gᵀ``,
    vectorized over elements. Returns (n_elems, d+1, d+1)."""
    G, vol = _p1_gradients(coords, elems)
    return kappa * vol[:, None, None] * np.einsum("eid,ejd->eij", G, G)


def load_vector(coords, elems, n_nodes: int, source: float = 1.0) -> np.ndarray:
    """Consistent P1 load vector for a constant source term."""
    elems = np.asarray(elems)
    _, vol = _element_geometry(coords, elems)
    d = elems.shape[1] - 1
    contrib = (source / (d + 1)) * vol  # per vertex of each element
    f = np.zeros((n_nodes,), dtype=np.float64)
    for v in range(d + 1):
        np.add.at(f, elems[:, v], contrib)
    return f


def assemble_dense(n_dofs: int, elems, Ke) -> np.ndarray:
    """Scatter per-element stiffness into a dense (n, n) matrix."""
    elems = np.asarray(elems)
    Ke = np.asarray(Ke)
    d1 = elems.shape[1]
    rows = np.repeat(elems, d1, axis=1).reshape(-1)
    cols = np.tile(elems, (1, d1)).reshape(-1)
    K = np.zeros((n_dofs, n_dofs), dtype=Ke.dtype)
    np.add.at(K, (rows, cols), Ke.reshape(-1))
    return K


def assemble_scipy_csr(n_dofs: int, elems, Ke) -> sps.csr_matrix:
    """Reference-oracle CSR assembly (host-side validation only)."""
    elems = np.asarray(elems)
    Ke = np.asarray(Ke)
    d1 = elems.shape[1]
    rows = np.repeat(elems, d1, axis=1).reshape(-1)
    cols = np.tile(elems, (1, d1)).reshape(-1)
    K = sps.coo_matrix((Ke.reshape(-1), (rows, cols)), shape=(n_dofs, n_dofs))
    return K.tocsr()
