"""Sparsity-utilizing SYRK variants (paper §3.3), batched over subdomains
(counterpart of ``repro.core.syrk``).

Computes ``F = Yᵀ Y`` for stepped ``Y`` (S, n, m) — zeros above the column
pivots survive forward substitution, so Y carries B̃ᵀ's stepped envelope.

Variants:
  * ``syrk_dense``        — baseline full product (paper §3.1).
  * ``syrk_input_split``  — row blocks of Y (paper Fig. 4a): block k is
                            nonzero only in its leading ``widths[k]``
                            columns, so it updates the top-left w×w corner.
  * ``syrk_output_split`` — tiles of F (paper Fig. 4b): output block row I
                            needs input rows from the pivot of column block
                            I on (k-dimension reduction).

Results are full symmetric matrices (both triangles filled).
"""
from __future__ import annotations

import torch

from repro_torch.core.stepped import SteppedMeta

__all__ = ["syrk_dense", "syrk_input_split", "syrk_output_split"]


def _check(Y: torch.Tensor, meta: SteppedMeta) -> None:
    if tuple(Y.shape[-2:]) != (meta.n, meta.m):
        raise ValueError(f"Y shape {tuple(Y.shape)} != meta (S,{meta.n},{meta.m})")


def syrk_dense(Y: torch.Tensor) -> torch.Tensor:
    """Baseline: full dense SYRK F = YᵀY."""
    return Y.mT @ Y


def syrk_input_split(Y: torch.Tensor, meta: SteppedMeta) -> torch.Tensor:
    """Input (row-block) splitting, paper Fig. 4a."""
    _check(Y, meta)
    F = Y.new_zeros(Y.shape[:-2] + (meta.m, meta.m))
    for k in range(meta.num_row_blocks):
        r0, r1 = meta.row_block(k)
        w = int(meta.widths[k])
        if w == 0:
            continue
        Yk = Y[:, r0:r1, :w]
        F[:, :w, :w] += Yk.mT @ Yk
    return F


def syrk_output_split(Y: torch.Tensor, meta: SteppedMeta) -> torch.Tensor:
    """Output (block-row of F) splitting, paper Fig. 4b: the diagonal block
    is an inner SYRK, the strip to its left one GEMM (mirrored)."""
    _check(Y, meta)
    F = Y.new_zeros(Y.shape[:-2] + (meta.m, meta.m))
    for i in range(meta.num_col_blocks):
        i0, i1 = meta.col_block(i)
        s = int(meta.col_starts[i])
        if s >= meta.n:  # structurally zero columns -> zero row/col of F
            continue
        Ci = Y[:, s:, i0:i1]
        F[:, i0:i1, i0:i1] = Ci.mT @ Ci
        if i0 > 0:
            strip = Ci.mT @ Y[:, s:, :i0]
            F[:, i0:i1, :i0] = strip
            F[:, :i0, i0:i1] = strip.mT
    return F
