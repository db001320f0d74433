"""Blocked numerical Cholesky, batched over subdomains (paper §2.2's
numerical stage; counterpart of ``repro.sparse.cholesky``).

Right-looking block Cholesky over a uniform block grid. With a block fill
mask from the symbolic stage, structurally-zero blocks are skipped: every
surviving block is a dense tile. Per block it calls
``torch.linalg.cholesky_ex`` and ``torch.linalg.solve_triangular`` on the
whole (S, bs, bs) batch — the reference computes these outside any Pallas
kernel too.

The reference builds L functionally (``.at[].set``) beside the working
matrix. Here ONE working stack is updated in place and becomes L: at full
size each (S, n, n) f64 stack is ~9 GB, and a second one would double the
device footprint of the factorization.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["block_cholesky"]


def _solve_lower_right(Lkk: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Solve X Lkkᵀ = W for X (i.e. X = W Lkk⁻ᵀ), batched."""
    return torch.linalg.solve_triangular(Lkk.mT, W, upper=True, left=False)


def block_cholesky(K: torch.Tensor, block_size: int,
                   mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """Cholesky factors of an SPD stack, computed IN PLACE.

    Args:
      K: (S, n, n) SPD matrices; overwritten with their lower factors L
        (strict upper triangle zeroed) and returned.
      block_size: tile size.
      mask: optional (nb, nb) lower-triangular block fill mask from
        :func:`repro_torch.sparse.symbolic.block_symbolic_cholesky`. Blocks
        outside the mask are skipped entirely (they stay zero).

    Raises ``ValueError`` if a diagonal block is not positive definite.
    """
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"expected an (S, n, n) stack, got {tuple(K.shape)}")
    n = K.shape[1]
    nb = -(-n // block_size)

    def blk(k):
        return k * block_size, min((k + 1) * block_size, n)

    if mask is not None:
        mask = np.asarray(mask)
        if mask.shape != (nb, nb):
            raise ValueError(f"mask shape {mask.shape} != ({nb},{nb})")

    W = K
    infos = []
    for k in range(nb):
        k0, k1 = blk(k)
        Lkk, info = torch.linalg.cholesky_ex(W[:, k0:k1, k0:k1])
        infos.append(info)
        W[:, k0:k1, k0:k1] = Lkk
        if k1 >= n:
            break
        if mask is None:
            panel = _solve_lower_right(Lkk, W[:, k1:, k0:k1])
            W[:, k1:, k0:k1] = panel
            W[:, k1:, k1:] -= panel @ panel.mT
            continue
        below = [i for i in range(k + 1, nb) if mask[i, k]]
        panels = {}
        for i in below:
            i0, i1 = blk(i)
            Lik = _solve_lower_right(Lkk, W[:, i0:i1, k0:k1])
            W[:, i0:i1, k0:k1] = Lik
            panels[i] = (i0, i1, Lik)
        for i in below:
            i0, i1, Lik = panels[i]
            for j in below:
                if j > i:
                    break
                j0, j1, Ljk = panels[j]
                W[:, i0:i1, j0:j1] -= Lik @ Ljk.mT
    bad = torch.stack(infos).ne(0).any()
    if bool(bad):
        raise ValueError("block_cholesky: a diagonal block is not positive "
                         "definite")
    return W.tril_()
