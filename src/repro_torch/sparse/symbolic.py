"""Symbolic block factorization (host-side, paper §2.2's symbolic stage).

Numpy-only copy of ``repro.sparse.symbolic``.

Maps the scalar sparsity pattern of the (permuted) subdomain matrix onto a
uniform block grid and runs symbolic elimination at block granularity,
producing the lower-triangular *block fill mask* of the Cholesky factor.

The mask drives (a) the block-sparse numerical Cholesky (cholesky.py),
(b) the pruning of factor-split TRSM updates (core/trsm.py), and
(c) the FLOP model used by the benchmarks. This is the blocked analogue
of CSR symbolic factorization: zero/nonzero is decided per dense tile,
not per scalar.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "matrix_pattern_from_elems",
    "block_pattern",
    "block_symbolic_cholesky",
]


def matrix_pattern_from_elems(n: int, elems: np.ndarray) -> np.ndarray:
    """Dense boolean pattern of the assembled FEM matrix (host-side)."""
    pat = np.zeros((n, n), dtype=bool)
    elems = np.asarray(elems)
    for v in range(elems.shape[1]):
        for w in range(elems.shape[1]):
            pat[elems[:, v], elems[:, w]] = True
    return pat


def block_pattern(pattern: np.ndarray, block_size: int) -> np.ndarray:
    """Reduce a scalar (n, n) pattern to a (nb, nb) block pattern."""
    n = pattern.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        pattern = np.pad(pattern, ((0, pad), (0, pad)))
    blocked = pattern.reshape(nb, block_size, nb, block_size)
    return blocked.any(axis=(1, 3))


def block_symbolic_cholesky(bpat: np.ndarray) -> np.ndarray:
    """Symbolic elimination at block level: returns the lower-triangular
    block fill mask of L (True = structurally nonzero block).

    Standard fill rule: eliminating block column k connects every pair of
    blocks below it — ``mask[i, j] |= mask[i, k] & mask[j, k]`` for i>=j>k.
    """
    nb = bpat.shape[0]
    mask = np.tril(bpat | bpat.T)
    for k in range(nb):
        below = np.flatnonzero(mask[k + 1 :, k]) + k + 1
        if below.size:
            # vectorized pairwise fill
            mask[np.ix_(below, below)] |= True
    return np.tril(mask)
