"""Shared test fixtures: random sparse SPD systems and FETI-like gluing
patterns with controllable stepped structure (numpy copies of
``repro.testing``'s: the same draws for the same generator)."""
from __future__ import annotations

import numpy as np

__all__ = [
    "random_banded_spd",
    "random_lower_banded",
    "random_feti_like_bt",
    "block_fill_mask_from_factor",
]


def random_banded_spd(n: int, bandwidth: int, rng: np.random.Generator,
                      dtype=np.float64) -> np.ndarray:
    """Random well-conditioned SPD matrix with the given (half-)bandwidth."""
    A = np.zeros((n, n), dtype=dtype)
    for d in range(bandwidth + 1):
        v = rng.standard_normal(n - d).astype(dtype) * (0.5 ** d)
        A += np.diag(v, -d)
    A = A @ A.T
    A += np.eye(n, dtype=dtype) * (np.trace(A) / n * 0.1 + 1.0)
    return A


def random_lower_banded(n: int, bandwidth: int, rng: np.random.Generator,
                        fill: float = 0.5, dtype=np.float64) -> np.ndarray:
    """Random nonsingular lower-triangular factor with banded sparsity."""
    L = np.zeros((n, n), dtype=dtype)
    for i in range(n):
        lo = max(0, i - bandwidth)
        row = rng.standard_normal(i - lo).astype(dtype)
        row *= rng.random(i - lo) < fill
        L[i, lo:i] = row * 0.3
        L[i, i] = 1.0 + rng.random()
    return L


def random_feti_like_bt(n: int, m: int, rng: np.random.Generator,
                        nnz_per_col: int = 2, spread: int = 4,
                        dtype=np.float64) -> np.ndarray:
    """Random B̃ᵀ: each column has a few ±1 entries clustered around a random
    anchor row — mimics FETI gluing where each Lagrange multiplier touches a
    couple of interface DOFs. Column pivots end up roughly uniform over rows
    (the property the paper needs from the fill-reducing ordering)."""
    Bt = np.zeros((n, m), dtype=dtype)
    anchors = rng.integers(0, n, size=m)
    for j in range(m):
        a = int(anchors[j])
        rows = np.clip(a + rng.integers(0, spread + 1, size=nnz_per_col), 0, n - 1)
        for r in np.unique(rows):
            Bt[r, j] = rng.choice([-1.0, 1.0])
    return Bt


def block_fill_mask_from_factor(L: np.ndarray, block_size: int) -> np.ndarray:
    """Lower-triangular block fill mask: True where an L block has any nnz."""
    n = L.shape[0]
    nb = -(-n // block_size)
    mask = np.zeros((nb, nb), dtype=bool)
    for i in range(nb):
        i0, i1 = i * block_size, min((i + 1) * block_size, n)
        for k in range(i + 1):
            k0, k1 = k * block_size, min((k + 1) * block_size, n)
            mask[i, k] = np.any(L[i0:i1, k0:k1] != 0)
    return mask
