"""P1 finite-element assembly for the scalar heat-transfer (Laplace)
problem and vector-valued linear elasticity, in numpy (counterpart of
``repro.fem.assembly``).

Element stiffness is vectorized over elements; the dense scatter builds
the per-subdomain matrices, the scipy CSR path is the reference oracle for
validating the FETI solve against an undecomposed global solve.

Vector problems use node-blocked DOF numbering: DOF ``node * d + c`` is
component ``c`` of ``node`` (d = 2 or 3 components per node). The scatter
assemblers are index-generic, so both problems share them through
:func:`element_dofs`.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sps

__all__ = [
    "p1_element_stiffness",
    "p1_elasticity_stiffness",
    "elasticity_matrix",
    "element_dofs",
    "load_vector",
    "elasticity_load_vector",
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


def elasticity_matrix(dim: int, lam: float = 1.0, mu: float = 1.0
                      ) -> np.ndarray:
    """Isotropic elasticity matrix C in Voigt notation (Lamé parameters).

    2D is plane strain (3 strain components: εxx, εyy, γxy); 3D has the
    full 6 (εxx, εyy, εzz, γxy, γyz, γxz). Shear rows use engineering
    strain, so the shear diagonal is μ.
    """
    if dim == 2:
        C = [[lam + 2 * mu, lam, 0.0],
             [lam, lam + 2 * mu, 0.0],
             [0.0, 0.0, mu]]
    elif dim == 3:
        C = [[lam + 2 * mu, lam, lam, 0, 0, 0],
             [lam, lam + 2 * mu, lam, 0, 0, 0],
             [lam, lam, lam + 2 * mu, 0, 0, 0],
             [0, 0, 0, mu, 0, 0],
             [0, 0, 0, 0, mu, 0],
             [0, 0, 0, 0, 0, mu]]
    else:
        raise ValueError("elasticity supports dim 2 or 3")
    return np.asarray(C, dtype=np.float64)


# (strain row, displacement component, gradient axis) of every nonzero of
# the P1 strain-displacement matrix, per node: εxx = ∂x ux, ..., and each
# engineering shear strain sums the two cross derivatives
_STRAIN_TERMS = {
    2: ((0, 0, 0), (1, 1, 1), (2, 0, 1), (2, 1, 0)),
    3: ((0, 0, 0), (1, 1, 1), (2, 2, 2),
        (3, 0, 1), (3, 1, 0), (4, 1, 2), (4, 2, 1), (5, 0, 2), (5, 2, 0)),
}


def _strain_displacement(G: np.ndarray) -> np.ndarray:
    """Element strain-displacement matrices B: (ne, n_strain, (d+1)*d).

    Node-blocked column order (node-major, component-minor), matching
    :func:`element_dofs`. Constant per element for P1.
    """
    ne, d1, d = G.shape
    B = np.zeros((ne, 3 if d == 2 else 6, d1 * d), dtype=G.dtype)
    for a in range(d1):
        for row, comp, axis in _STRAIN_TERMS[d]:
            B[:, row, d * a + comp] = G[:, a, axis]
    return B


def p1_elasticity_stiffness(coords, elems, lam: float = 1.0,
                            mu: float = 1.0) -> np.ndarray:
    """Per-element P1 linear-elasticity stiffness ``Ke = vol * Bᵀ C B``.

    Returns (n_elems, (d+1)*d, (d+1)*d) in node-blocked DOF order; scatter
    with ``element_dofs(elems, d)`` through the same assemblers as heat.
    """
    G, vol = _p1_gradients(coords, elems)
    C = elasticity_matrix(G.shape[2], lam, mu)
    B = _strain_displacement(G)
    return vol[:, None, None] * np.einsum("esi,st,etj->eij", B, C, B)


def element_dofs(elems, ndof_per_node: int) -> np.ndarray:
    """Expand node connectivity (ne, d+1) to DOF connectivity
    (ne, (d+1)*ndpn) in node-blocked order (DOF = node*ndpn + c)."""
    elems = np.asarray(elems)
    if ndof_per_node == 1:
        return elems
    return (elems[:, :, None] * ndof_per_node
            + np.arange(ndof_per_node)).reshape(elems.shape[0], -1)


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


def elasticity_load_vector(coords, elems, n_nodes: int, body_force
                           ) -> np.ndarray:
    """Consistent P1 load for a constant body force (d components).

    Returns the (n_nodes * d,) node-blocked DOF load vector.
    """
    comps = [load_vector(coords, elems, n_nodes, source=float(b))
             for b in body_force]
    return np.stack(comps, axis=1).reshape(n_nodes * len(comps))


def assemble_dense(n_dofs: int, elems, Ke) -> np.ndarray:
    """Scatter per-element stiffness into a dense (n, n) matrix.

    ``elems`` is any per-element index array (node connectivity for scalar
    problems, :func:`element_dofs` output for vector problems).
    """
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
