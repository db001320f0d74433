"""Fill-reducing orderings (host-side, symbolic phase — paper §2.2).

Numpy-only copy of ``repro.sparse.ordering``.

The paper uses Metis inside PARDISO/CHOLMOD. Our subdomains are structured
boxes, so we use *geometric nested dissection*, which is exactly what Metis
converges to on such grids and gives the two properties the paper's
technique relies on:

  * low fill in L with large zero off-diagonal blocks (block skipping), and
  * approximately uniformly distributed column pivots of B̃ᵀ after the
    permutation (the surface DOFs carrying B's nonzeros end up spread over
    the elimination order), which is what makes the stepped shape useful.

An RCM (bandwidth-minimizing) ordering is provided as an alternative; it
concentrates fill near the diagonal (good for the banded block mask) but
pushes all surface DOFs of one face together, so the stepped shape is
coarser. The benchmark harness compares both.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nested_dissection_order", "rcm_order", "node_ordering"]


def node_ordering(node_shape: tuple[int, ...], ordering: str) -> np.ndarray:
    """Dispatch a named fill-reducing node ordering ("nd" | "rcm" |
    "natural") for a structured node grid — the one mapping shared by the
    cluster preprocessor and the dirichlet boundary/interior split, so
    adding an ordering cannot silently diverge between them."""
    if ordering == "nd":
        return nested_dissection_order(node_shape)
    if ordering == "rcm":
        return rcm_order(node_shape)
    if ordering == "natural":
        return np.arange(int(np.prod(node_shape)), dtype=np.int64)
    raise ValueError(f"unknown ordering {ordering!r}")


def nested_dissection_order(node_shape: tuple[int, ...], leaf: int = 4) -> np.ndarray:
    """Geometric nested dissection of a structured node grid.

    Args:
      node_shape: nodes per axis, e.g. (9, 9) for an 8x8-element subdomain.
      leaf: boxes with every side <= leaf are emitted without further
        dissection.

    Returns:
      perm (n,) int64 such that ``K[perm][:, perm]`` has ND structure; i.e.
      ``perm[k]`` = original (Fortran-order) node id eliminated k-th.
    """
    dim = len(node_shape)
    strides = [1]
    for d in range(dim - 1):
        strides.append(strides[-1] * node_shape[d])
    strides_arr = np.asarray(strides)

    out: list[np.ndarray] = []

    def emit(box):
        ranges = [np.arange(lo, hi) for lo, hi in box]
        grid = np.meshgrid(*ranges, indexing="ij")
        ids = sum(g.ravel(order="F") * s for g, s in zip(grid, strides_arr))
        out.append(np.sort(ids))

    def dissect(box):
        sizes = [hi - lo for lo, hi in box]
        if max(sizes) <= leaf:
            emit(box)
            return
        ax = int(np.argmax(sizes))
        lo, hi = box[ax]
        mid = (lo + hi) // 2
        left = list(box)
        left[ax] = (lo, mid)
        right = list(box)
        right[ax] = (mid + 1, hi)
        sep = list(box)
        sep[ax] = (mid, mid + 1)
        dissect(left)
        if mid + 1 < hi:
            dissect(right)
        emit(sep)

    dissect([(0, s) for s in node_shape])
    perm = np.concatenate(out).astype(np.int64)
    n = int(np.prod(node_shape))
    assert perm.shape == (n,) and len(np.unique(perm)) == n
    return perm


def rcm_order(node_shape: tuple[int, ...]) -> np.ndarray:
    """Reverse Cuthill–McKee on the structured grid graph (via lexicographic
    anti-diagonal sweep, which is the exact RCM result for box grids)."""
    dim = len(node_shape)
    ranges = [np.arange(s) for s in node_shape]
    grid = np.meshgrid(*ranges, indexing="ij")
    idx = np.stack([g.ravel(order="F") for g in grid], axis=1)  # (n, dim)
    level = idx.sum(axis=1)  # BFS level from corner
    order = np.lexsort(tuple(idx[:, d] for d in range(dim)) + (level,))
    return order[::-1].astype(np.int64).copy()
