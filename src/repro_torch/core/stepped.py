"""Stepped-shape analysis of the RHS matrix B̃ᵀ (paper §3).

Numpy-only copy of ``repro.core.stepped``: the port keeps its own so it
never imports the JAX package.

The paper's optimization pivots on permuting the *columns* of B̃ᵀ (never the
rows — that would disturb the fill-reducing permutation of K) so the column
pivots (first nonzero per column) descend monotonically from left to right.
This "stepped" shape is what lets TRSM and SYRK skip the zero region above
the pivots.

Everything in this module is HOST-SIDE (numpy): the sparsity *pattern* of a
FETI decomposition is fixed across the multi-step simulation (symbolic /
numeric split, paper §2.2), so the metadata computed here is built once and reused by
every re-assembly.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "column_pivots",
    "stepped_permutation",
    "SteppedMeta",
    "build_stepped_meta",
    "shared_envelope",
]


def column_pivots(pattern: np.ndarray) -> np.ndarray:
    """First nonzero row index of each column; ``n`` for empty columns.

    ``pattern`` is a boolean (or truthy) (n, m) array representing the
    sparsity pattern of B̃ᵀ (rows = subdomain DOFs in fill-reducing order,
    columns = local Lagrange multipliers).
    """
    pattern = np.asarray(pattern) != 0
    n, m = pattern.shape
    has = pattern.any(axis=0)
    piv = np.where(has, pattern.argmax(axis=0), n)
    return piv.astype(np.int64)


def stepped_permutation(pivots: np.ndarray) -> np.ndarray:
    """Column permutation (stable sort by pivot) producing the stepped shape.

    Returns ``perm`` such that ``Bt[:, perm]`` has non-decreasing column
    pivots. Ties keep original order (stable), matching the paper's "equal
    column pivot indices are allowed in neighbouring columns".
    """
    return np.argsort(pivots, kind="stable").astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SteppedMeta:
    """Static per-pattern metadata driving the blocked stepped kernels.

    All integer arrays are host-side numpy; shapes/sizes are Python ints so
    they stay host-side constants.

    Attributes:
      n: factor dimension (rows of B̃ᵀ).
      m: number of RHS columns (local Lagrange multipliers).
      block_size: factor row-block size ``b`` (paper Table 1 "S <size>").
      rhs_block_size: RHS column-block size ``cb``.
      perm: column permutation applied to B̃ᵀ to reach stepped shape.
      inv_perm: inverse permutation (maps stepped index -> original index).
      pivots: per (permuted) column first-nonzero row; non-decreasing.
      num_row_blocks / num_col_blocks: ceil-divided block counts.
      widths: ``widths[k]`` = number of (permuted) columns active in factor
        row-block k, i.e. ``#{c : pivots[c] < end_k}``. Non-decreasing.
      col_starts: ``col_starts[c]`` = first possibly-nonzero row of RHS
        column-block c (its smallest pivot); non-decreasing.
    """

    n: int
    m: int
    block_size: int
    rhs_block_size: int
    perm: np.ndarray
    inv_perm: np.ndarray
    pivots: np.ndarray
    widths: np.ndarray
    col_starts: np.ndarray

    @property
    def num_row_blocks(self) -> int:
        return -(-self.n // self.block_size)

    @property
    def num_col_blocks(self) -> int:
        return -(-self.m // self.rhs_block_size)

    def row_block(self, k: int) -> tuple[int, int]:
        return k * self.block_size, min((k + 1) * self.block_size, self.n)

    def col_block(self, c: int) -> tuple[int, int]:
        return c * self.rhs_block_size, min((c + 1) * self.rhs_block_size, self.m)

    def width_at_row(self, r: int) -> int:
        """Number of columns with pivot <= r (active width at row r)."""
        return int(np.searchsorted(self.pivots, r, side="right"))

    # -- FLOP model (MACs counted as 2 flops), used by benchmarks & §Perf --

    def flops_trsm_dense(self) -> int:
        return self.n * self.n * self.m  # n^2/2 solve * m cols * 2 flops

    def flops_trsm_rhs_split(self) -> int:
        total = 0
        for c in range(self.num_col_blocks):
            c0, c1 = self.col_block(c)
            s = int(self.col_starts[c])
            nn = self.n - s
            total += nn * nn * (c1 - c0)
        return total

    def flops_trsm_factor_split(self) -> int:
        total = 0
        for k in range(self.num_row_blocks):
            r0, r1 = self.row_block(k)
            b = r1 - r0
            w = int(self.widths[k])
            total += b * b * w  # diagonal TRSM
            total += 2 * (self.n - r1) * b * w  # GEMM update
        return total

    def flops_syrk_dense(self) -> int:
        return self.n * self.m * self.m  # m^2/2 outputs * n * 2 flops

    def flops_syrk_input_split(self) -> int:
        total = 0
        for k in range(self.num_row_blocks):
            r0, r1 = self.row_block(k)
            w = int(self.widths[k])
            total += (r1 - r0) * w * w
        return total

    def flops_syrk_output_split(self) -> int:
        total = 0
        for i in range(self.num_col_blocks):
            i0, i1 = self.col_block(i)
            s = int(self.col_starts[i])
            kk = self.n - s
            # diagonal block (SYRK) + row of off-diagonal blocks (GEMM)
            total += kk * (i1 - i0) * (i1 - i0)
            total += 2 * kk * (i1 - i0) * i0
        return total


def build_stepped_meta(
    pattern: np.ndarray,
    block_size: int = 128,
    rhs_block_size: int | None = None,
    presorted: bool = False,
) -> SteppedMeta:
    """Analyse a B̃ᵀ sparsity pattern and build the stepped metadata.

    Args:
      pattern: (n, m) boolean-ish sparsity pattern of B̃ᵀ in the factor's
        (fill-reducing) row order and the original column order.
      block_size: factor row-block size (paper's block-size hyperparameter).
      rhs_block_size: RHS column-block size; defaults to ``block_size``.
      presorted: if True, assume columns are already stepped (perm=identity).
    """
    pattern = np.asarray(pattern) != 0
    n, m = pattern.shape
    if rhs_block_size is None:
        rhs_block_size = block_size
    piv_orig = column_pivots(pattern)
    if presorted:
        perm = np.arange(m, dtype=np.int64)
    else:
        perm = stepped_permutation(piv_orig)
    pivots = piv_orig[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(m, dtype=np.int64)

    nb = -(-n // block_size)
    widths = np.empty(nb, dtype=np.int64)
    for k in range(nb):
        end_k = min((k + 1) * block_size, n)
        widths[k] = np.searchsorted(pivots, end_k - 1, side="right")

    cb = -(-m // rhs_block_size)
    col_starts = np.empty(cb, dtype=np.int64)
    for c in range(cb):
        c0 = c * rhs_block_size
        col_starts[c] = min(pivots[c0], n)

    return SteppedMeta(
        n=n,
        m=m,
        block_size=int(block_size),
        rhs_block_size=int(rhs_block_size),
        perm=perm,
        inv_perm=inv_perm,
        pivots=pivots,
        widths=widths,
        col_starts=col_starts,
    )


def shared_envelope(metas: Sequence[SteppedMeta]) -> SteppedMeta:
    """Combine several same-shape metas into one conservative envelope.

    Used to batch subdomains with *different* B̃ᵀ patterns through one
    batched launch (the analogue of the paper's 16 CUDA streams):
    skipping is only applied where *all* batched patterns are zero, which
    keeps the batched kernel correct for every member.
    """
    first = metas[0]
    for me in metas[1:]:
        if (me.n, me.m, me.block_size, me.rhs_block_size) != (
            first.n,
            first.m,
            first.block_size,
            first.rhs_block_size,
        ):
            raise ValueError("shared_envelope requires identical shapes/blocks")
    widths = np.max([me.widths for me in metas], axis=0)
    col_starts = np.min([me.col_starts for me in metas], axis=0)
    pivots = np.min([me.pivots for me in metas], axis=0)
    return SteppedMeta(
        n=first.n,
        m=first.m,
        block_size=first.block_size,
        rhs_block_size=first.rhs_block_size,
        perm=np.arange(first.m, dtype=np.int64),
        inv_perm=np.arange(first.m, dtype=np.int64),
        pivots=pivots,
        widths=widths,
        col_starts=col_starts,
    )
