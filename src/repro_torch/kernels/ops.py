"""Wrappers around the stepped kernels (counterpart of
``repro.kernels.ops``).

Handles everything the kernels require to stay simple: padding to block
multiples (identity-padded factor diagonal), per-stripe start-block
metadata derived from the stepped pivots (and from it, on the host, the
fused kernels' item list, cached per plan and device), pre-inversion of
the factor's diagonal blocks (for a packed factor, its diagonal slots),
and the mirror of SYRK's lower block triangle. Every function takes a leading subdomain
axis S; one shared (envelope) ``SteppedMeta`` describes all S. Operands
keep their dtype (float64, or float32 for reduced-precision stacks, whose
diagonal blocks are then inverted at f32 as the reference does), and the
wrappers pick the kernel of that dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stepped import SteppedMeta
from repro_torch.kernels.schedule import fused_work_order_on
from repro_torch.kernels.stepped_syrk import stepped_syrk_kernel
from repro_torch.kernels.stepped_trsm import (
    stepped_trsm_kernel,
    stepped_trsm_packed_kernel,
)
from repro_torch.kernels.stepped_trsm_syrk import (
    stepped_trsm_syrk_kernel,
    stepped_trsm_syrk_packed_kernel,
)
from repro_torch.sparse.packed import PackedBlocks

__all__ = [
    "stepped_trsm",
    "stepped_trsm_packed",
    "stepped_syrk",
    "stepped_trsm_syrk",
    "invert_diag_blocks",
    "invert_packed_diag",
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
    return _invert_lower(torch.diagonal(blocks, dim1=1, dim2=3).permute(0, 3, 1, 2))


def invert_packed_diag(L: PackedBlocks) -> torch.Tensor:
    """(S, nb, bs, bs) inverses of a packed factor's diagonal slots, which
    are identity-padded by construction (``pack_factor`` /
    ``block_cholesky_packed``), hence always invertible."""
    index = L.index
    slots = torch.as_tensor(index.diag_slots, dtype=torch.long,
                            device=L.values.device)
    return _invert_lower(L.values[:, slots])


def _invert_lower(diag: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(diag.shape[-1], dtype=diag.dtype, device=diag.device)
    return torch.linalg.solve_triangular(diag, eye.expand(diag.shape),
                                         upper=False).contiguous()


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


def _starts(meta: SteppedMeta, device) -> torch.Tensor:
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    return torch.as_tensor(_start_blocks(meta, bm, bs, m_pad, n_pad),
                           device=device)


def _fused_order(meta: SteppedMeta, S: int, device, index=None
                 ) -> torch.Tensor:
    """The fused kernels' item list on ``device`` from the host start
    blocks (and a packed factor's block ``index``), cached per plan."""
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    csr = () if index is None else (index.rowptr, index.cols)
    return fused_work_order_on(device,
                               _start_blocks(meta, bm, bs, m_pad, n_pad), S,
                               n_pad // bs, m_pad, bm, *csr)


def _packed_operands(L: PackedBlocks, meta: SteppedMeta):
    """(Linv, values, rowptr, colidx) of a packed factor built at the
    meta's block size."""
    index = L.index
    if (index.bs, index.n) != (meta.block_size, meta.n):
        raise ValueError(
            f"packed index (n={index.n}, bs={index.bs}) does not match "
            f"stepped meta (n={meta.n}, bs={meta.block_size})")
    dev = L.values.device
    return (invert_packed_diag(L), L.values,
            torch.as_tensor(index.rowptr, device=dev),
            torch.as_tensor(index.cols, device=dev))


def stepped_trsm(L: torch.Tensor, B: torch.Tensor, meta: SteppedMeta
                 ) -> torch.Tensor:
    """Stepped TRSM with :func:`repro_torch.core.trsm.trsm_rhs_split`'s
    semantics: L (S, n, n), B (S, n, m) already in stepped column order."""
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    Lp = pad_factor(L, n_pad)
    Y = stepped_trsm_kernel(invert_diag_blocks(Lp, bs), Lp,
                            _pad_to(B, n_pad, m_pad), _starts(meta, L.device),
                            bs=bs, bm=bm)
    return Y[:, :meta.n, :meta.m]


def stepped_trsm_packed(L: PackedBlocks, B: torch.Tensor, meta: SteppedMeta
                        ) -> torch.Tensor:
    """Stepped TRSM against a packed factor stack (``L.values`` is
    (S, n_blocks, bs, bs), its index built at ``meta``'s block size): only
    the stored blocks reach the kernel, never a dense (S, n, n) factor."""
    if not isinstance(L, PackedBlocks):
        raise TypeError("stepped_trsm_packed expects a PackedBlocks factor, "
                        f"got {type(L).__name__}")
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    Y = stepped_trsm_packed_kernel(*_packed_operands(L, meta),
                                   _pad_to(B, n_pad, m_pad),
                                   _starts(meta, B.device), bs=bs, bm=bm)
    return Y[:, :meta.n, :meta.m]


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
    Fl = stepped_syrk_kernel(_pad_to(Y, n_pad, m_pad), _starts(meta, Y.device),
                             bs=bs, bm=bm)
    return _mirror_lower(Fl, bm, m_pad, meta.m)


def stepped_trsm_syrk(L, B: torch.Tensor, meta: SteppedMeta) -> torch.Tensor:
    """Fused TRSM→SYRK: the full symmetric F = (L⁻¹B)ᵀ(L⁻¹B) per subdomain
    from one kernel launch. ``L`` is a dense (S, n, n) factor stack or a
    :class:`~repro_torch.sparse.packed.PackedBlocks`; dispatches
    accordingly."""
    bs, bm, n_pad, m_pad = _padded_sizes(meta)
    Bp = _pad_to(B, n_pad, m_pad)
    starts = _starts(meta, B.device)
    if isinstance(L, PackedBlocks):
        operands = _packed_operands(L, meta)
        order = _fused_order(meta, B.shape[0], B.device, L.index)
        Fl = stepped_trsm_syrk_packed_kernel(*operands, Bp, starts, bs=bs,
                                             bm=bm, order=order)
    else:
        Lp = pad_factor(L, n_pad)
        Fl = stepped_trsm_syrk_kernel(invert_diag_blocks(Lp, bs), Lp, Bp,
                                      starts, bs=bs, bm=bm,
                                      order=_fused_order(meta, B.shape[0],
                                                         B.device))
    return _mirror_lower(Fl, bm, m_pad, meta.m)
