"""Sparsity-utilizing TRSM variants (paper §3.2), batched over subdomains
(counterpart of ``repro.core.trsm``).

Solves ``L Y = B`` for lower-triangular factors ``L`` (S, n, n) and
*stepped* right-hand sides ``B`` (S, n, m) — columns permuted so pivots
are non-decreasing; one shared ``SteppedMeta`` describes all S.

Variants:
  * ``trsm_dense``         — the baseline: one library TRSM (paper §3.1).
  * ``trsm_rhs_split``     — RHS column-block splitting (paper Fig. 3a).
  * ``trsm_factor_split``  — factor blocking with optional pruning of
                             structurally-zero factor blocks (paper Fig. 3b).

``trsm_factor_split_packed`` runs the factor-split schedule on a packed
factor (:mod:`repro_torch.sparse.packed`), where pruning is structural.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.stepped import SteppedMeta
from repro_torch.sparse.packed import PackedBlocks

__all__ = [
    "trsm_dense",
    "trsm_rhs_split",
    "trsm_factor_split",
    "trsm_factor_split_packed",
]


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def _check(B: torch.Tensor, meta: SteppedMeta) -> None:
    if tuple(B.shape[-2:]) != (meta.n, meta.m):
        raise ValueError(f"B shape {tuple(B.shape)} != meta (S,{meta.n},{meta.m})")


def trsm_dense(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Baseline: full dense TRSM, no sparsity utilization (paper §3.1)."""
    return _solve_lower(L, B)


def trsm_rhs_split(L: torch.Tensor, B: torch.Tensor, meta: SteppedMeta
                   ) -> torch.Tensor:
    """RHS splitting (paper Fig. 3a): column block ``c`` is solved against
    only the trailing subfactor ``L[s_c:, s_c:]`` — rows above its smallest
    pivot are zero and stay zero under forward substitution."""
    _check(B, meta)
    Y = torch.zeros_like(B)
    for c in range(meta.num_col_blocks):
        c0, c1 = meta.col_block(c)
        s = int(meta.col_starts[c])
        if s >= meta.n:  # all-zero column block: solution stays zero
            continue
        Y[:, s:, c0:c1] = _solve_lower(L[:, s:, s:], B[:, s:, c0:c1])
    return Y


def trsm_factor_split(L: torch.Tensor, B: torch.Tensor, meta: SteppedMeta,
                      block_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """Factor splitting with optional pruning (paper Fig. 3b).

    Blocked forward substitution. At factor block-row ``k`` only the leading
    ``widths[k]`` RHS columns can be nonzero; the diagonal TRSM and the GEMM
    update of the rows below are restricted to them. With ``block_mask``
    (the lower-triangular block fill pattern of ``L``) the updates from
    structurally-zero factor blocks are skipped.
    """
    _check(B, meta)
    nb = meta.num_row_blocks
    if block_mask is not None:
        block_mask = np.asarray(block_mask)
        if block_mask.shape != (nb, nb):
            raise ValueError(f"block_mask shape {block_mask.shape} != ({nb},{nb})")
    Y = B.clone()
    n = meta.n
    for k in range(nb):
        r0, r1 = meta.row_block(k)
        w = int(meta.widths[k])
        if w == 0:
            continue
        Yk = _solve_lower(L[:, r0:r1, r0:r1], Y[:, r0:r1, :w])
        Y[:, r0:r1, :w] = Yk
        if r1 >= n:
            continue
        if block_mask is None:
            Y[:, r1:, :w] -= L[:, r1:, r0:r1] @ Yk
            continue
        for i in range(k + 1, nb):
            if not block_mask[i, k]:
                continue
            i0, i1 = meta.row_block(i)
            Y[:, i0:i1, :w] -= L[:, i0:i1, r0:r1] @ Yk
    return Y


def trsm_factor_split_packed(L: PackedBlocks, B: torch.Tensor,
                             meta: SteppedMeta) -> torch.Tensor:
    """Factor splitting on a PACKED factor stack.

    The blocked forward substitution of :func:`trsm_factor_split`, with the
    factor blocks taken from the (S, n_blocks, bs, bs) value stack instead
    of sliced out of a dense (S, n, n) one: blocks absent from the layout
    do not exist, so pruning is inherent. Ragged last blocks are sliced out
    of the identity-padded stored tiles.
    """
    if not isinstance(L, PackedBlocks):
        raise TypeError("trsm_factor_split_packed expects a PackedBlocks "
                        f"factor, got {type(L).__name__}")
    index = L.index
    vals = L.values
    _check(B, meta)
    if (index.bs, index.n) != (meta.block_size, meta.n):
        raise ValueError(
            f"packed index (n={index.n}, bs={index.bs}) does not match "
            f"stepped meta (n={meta.n}, bs={meta.block_size})")
    Y = B.clone()
    n = meta.n
    for k in range(meta.num_row_blocks):
        r0, r1 = meta.row_block(k)
        b = r1 - r0
        w = int(meta.widths[k])
        if w == 0:
            continue
        Lkk = vals[:, index.slot(k, k), :b, :b]
        Yk = _solve_lower(Lkk, Y[:, r0:r1, :w])
        Y[:, r0:r1, :w] = Yk
        if r1 >= n:
            continue
        for i, s in index.col_slots(k):
            i0, i1 = meta.row_block(i)
            Y[:, i0:i1, :w] -= vals[:, s, : i1 - i0, :b] @ Yk
    return Y
