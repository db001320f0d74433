"""Wrappers around the stepped kernels (counterpart of the dense half of
``repro.kernels.ops``).

Handles everything the kernels require to stay simple: padding to block
multiples (identity-padded factor diagonal), per-stripe start-block
metadata derived from the stepped pivots, pre-inversion of the factor's
diagonal blocks, and the mirror of SYRK's lower block triangle. Every
function takes a leading subdomain axis S; one shared (envelope)
``SteppedMeta`` describes all S.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stepped import SteppedMeta
from repro_torch.kernels.stepped_syrk import stepped_syrk_kernel
from repro_torch.kernels.stepped_trsm import stepped_trsm_kernel

__all__ = [
    "stepped_trsm",
    "stepped_syrk",
    "invert_diag_blocks",
    "pad_factor",
]


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad the last two axes of ``x`` to (rows, cols)."""
    pr, pc = rows - x.shape[-2], cols - x.shape[-1]
    if pr == 0 and pc == 0:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, pc, 0, pr))


def pad_factor(L: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(S, n, n) factors zero-padded to (S, n_pad, n_pad) with an identity
    on the padded diagonal, which keeps every diagonal block invertible."""
    n = L.shape[-1]
    Lp = _pad_to(L, n_pad, n_pad)
    if n_pad > n:
        idx = torch.arange(n, n_pad, device=L.device)
        Lp[:, idx, idx] = 1.0
    return Lp


def invert_diag_blocks(L: torch.Tensor, bs: int) -> torch.Tensor:
    """(S, nb, bs, bs) inverses of the padded factors' diagonal blocks.

    Triangular solves against the identity (a library call, as in the
    reference, which computes them outside the Pallas kernel); cost
    S·nb·bs³, small next to the TRSM, and it turns the kernel's diagonal
    step into a product.
    """
    S, n, _ = L.shape
    nb = n // bs
    blocks = L.reshape(S, nb, bs, nb, bs)
    diag = torch.diagonal(blocks, dim1=1, dim2=3).permute(0, 3, 1, 2)
    eye = torch.eye(bs, dtype=L.dtype, device=L.device).expand(S, nb, bs, bs)
    return torch.linalg.solve_triangular(diag, eye, upper=False).contiguous()


def _start_blocks(meta: SteppedMeta, bm: int, bs: int, m_pad: int,
                  n_pad: int) -> np.ndarray:
    """First factor block each padded column stripe contributes from;
    ``nb`` for stripes past ``m`` (all-padding stripes stay zero)."""
    nb = n_pad // bs
    nc = m_pad // bm
    starts = np.full((nc,), nb, dtype=np.int32)
    for c in range(nc):
        c0 = c * bm
        if c0 < meta.m:
            piv = int(meta.pivots[c0])
            starts[c] = min(piv // bs, nb)
    return starts


def _padded_sizes(meta: SteppedMeta):
    bs, bm = meta.block_size, meta.rhs_block_size
    return bs, bm, -(-meta.n // bs) * bs, -(-meta.m // bm) * bm


def stepped_trsm(L: torch.Tensor, B: torch.Tensor, meta: SteppedMeta
                 ) -> torch.Tensor:
    """Stepped TRSM with :func:`repro_torch.core.trsm.trsm_rhs_split`'s
    semantics: L (S, n, n), B (S, n, m) already in stepped column order."""
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    n, m = meta.n, meta.m
    Lp = pad_factor(L, n_pad)
    Bp = _pad_to(B, n_pad, m_pad)
    starts = torch.as_tensor(_start_blocks(meta, bm, bs, m_pad, n_pad),
                             device=L.device)
    Linv = invert_diag_blocks(Lp, bs)
    Y = stepped_trsm_kernel(Linv, Lp, Bp, starts, bs=bs, bm=bm)
    return Y[:, :n, :m]


def _mirror_lower(Fl: torch.Tensor, bm: int, m_pad: int, m: int
                  ) -> torch.Tensor:
    """Mirror the strictly-lower block triangle (diagonal tiles are full);
    the strict-upper tiles of ``Fl`` must be zero."""
    nc = m_pad // bm
    tile = torch.arange(nc, device=Fl.device).repeat_interleave(bm)
    strict = tile[:, None] > tile[None, :]
    F = Fl + torch.where(strict, Fl, 0.0).mT
    return F[:, :m, :m]


def stepped_syrk(Y: torch.Tensor, meta: SteppedMeta) -> torch.Tensor:
    """Stepped SYRK: full symmetric F = YᵀY per subdomain (lower block
    triangle from the kernel, strict-lower tiles mirrored here)."""
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    Yp = _pad_to(Y, n_pad, m_pad)
    starts = torch.as_tensor(_start_blocks(meta, bm, bs, m_pad, n_pad),
                             device=Y.device)
    Fl = stepped_syrk_kernel(Yp, starts, bs=bs, bm=bm)
    return _mirror_lower(Fl, bm, m_pad, meta.m)
