"""Stepped TRSM: the hand-written CUDA kernels and their plain versions.

Solves ``L Y = B`` for a stepped B, batched over subdomains (paper §3.2),
against a dense factor or a packed one (:mod:`repro_torch.sparse.packed`).
The CUDA kernels (``csrc/stepped_trsm.cu``) replace the TPU kernels
``repro/kernels/stepped_trsm.py::stepped_trsm_pallas`` and
``::stepped_trsm_packed_pallas``, at float64 and at float32 (the TPU kernels
accumulate sub-f64 inputs in f32; bf16 storage runs its prep at f32); the
source note says what bounds them on the card and what the design does
about that.

:func:`stepped_trsm_kernel` and :func:`stepped_trsm_packed_kernel` are the
wrappers the pipeline calls: for CUDA tensors they launch the kernel (or
raise), for CPU tensors they run the plain version, the same schedule
written in torch ops. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (
    SUFFIX,
    check_cuda_tiles,
    check_operands,
    count_launch,
    counted,
    stream_of,
)

__all__ = [
    "stepped_trsm_kernel",
    "stepped_trsm_plain",
    "stepped_trsm_packed_kernel",
    "stepped_trsm_packed_plain",
]


def stepped_trsm_plain(Linv: torch.Tensor, L: torch.Tensor, B: torch.Tensor,
                       start_block: torch.Tensor, bs: int, bm: int
                       ) -> torch.Tensor:
    """The TPU kernel's schedule in torch ops, batched over S.

    One ``bm``-column stripe at a time: forward substitution over block rows
    ``k >= start_block[c]``, the update of row k taken against the factor
    tiles ``j in [start, k)`` (one product over that range), then
    ``Y_k = Linv[k] @ acc``. Rows above a stripe's start, and whole padded
    stripes (start = nb), stay zero.
    """
    S, n, m = B.shape
    nb = n // bs
    Y = torch.zeros_like(B)
    for c, start in enumerate(start_block.tolist()):
        cols = slice(c * bm, (c + 1) * bm)
        s0 = start * bs
        for k in range(start, nb):
            rk = slice(k * bs, (k + 1) * bs)
            acc = B[:, rk, cols]
            if k > start:
                acc = acc - L[:, rk, s0:k * bs] @ Y[:, s0:k * bs, cols]
            Y[:, rk, cols] = Linv[:, k] @ acc
    return Y


def stepped_trsm_packed_plain(Linv: torch.Tensor, values: torch.Tensor,
                              rowptr: torch.Tensor, colidx: torch.Tensor,
                              B: torch.Tensor, start_block: torch.Tensor,
                              bs: int, bm: int) -> torch.Tensor:
    """The packed TPU kernel's schedule in torch ops, batched over S.

    As :func:`stepped_trsm_plain`, but the update of row k walks the row's
    stored slots ``t in [rowptr[k], rowptr[k+1] - 1)`` (the diagonal slot
    is last and applied through ``Linv``) with block column
    ``colidx[t] >= start``, all in one product: the tiles side by side
    against the matching rows of Y.
    """
    S, n, m = B.shape
    nb = n // bs
    rp, ci = rowptr.tolist(), colidx.tolist()
    Y = torch.zeros_like(B)
    for c, start in enumerate(start_block.tolist()):
        cols = slice(c * bm, (c + 1) * bm)
        for k in range(start, nb):
            rk = slice(k * bs, (k + 1) * bs)
            acc = B[:, rk, cols]
            ts = [t for t in range(rp[k], rp[k + 1] - 1) if ci[t] >= start]
            if ts:
                Lrow = values[:, ts].permute(0, 2, 1, 3).reshape(S, bs, -1)
                rows = torch.cat([torch.arange(ci[t] * bs, (ci[t] + 1) * bs,
                                               device=B.device) for t in ts])
                acc = acc - Lrow @ Y[:, rows, cols]
            Y[:, rk, cols] = Linv[:, k] @ acc
    return Y


def check_dense_operands(Linv, L, B, start_block, bs, bm) -> torch.device:
    """Shapes of a dense-factor stepped TRSM; returns the operands' device."""
    dev = check_operands("stepped_trsm", Linv=Linv, L=L, B=B)
    S, n, m = B.shape
    if n % bs or m % bm:
        raise ValueError("inputs must be padded to block multiples (see ops.py)")
    if tuple(L.shape) != (S, n, n):
        raise ValueError(f"L shape {tuple(L.shape)} != {(S, n, n)}")
    _check_linv_starts(Linv, start_block, S, n, m, bs, bm)
    return dev


def check_packed_operands(Linv, values, rowptr, colidx, B, start_block, bs,
                          bm) -> torch.device:
    """Shapes of a packed-factor stepped TRSM; returns the operands' device."""
    dev = check_operands("stepped_trsm_packed", Linv=Linv, values=values, B=B)
    S, n, m = B.shape
    if n % bs or m % bm:
        raise ValueError("inputs must be padded to block multiples (see ops.py)")
    nb = n // bs
    if values.dim() != 4 or values.shape[0] != S \
            or tuple(values.shape[2:]) != (bs, bs):
        raise ValueError(f"values shape {tuple(values.shape)} != "
                         f"(S={S}, n_blocks, {bs}, {bs})")
    n_blocks = values.shape[1]
    if tuple(rowptr.shape) != (nb + 1,) or tuple(colidx.shape) != (n_blocks,):
        raise ValueError("rowptr/colidx shapes do not match the block index")
    _check_linv_starts(Linv, start_block, S, n, m, bs, bm)
    return dev


def _check_linv_starts(Linv, start_block, S, n, m, bs, bm) -> None:
    nb, nc = n // bs, m // bm
    if tuple(Linv.shape) != (S, nb, bs, bs):
        raise ValueError(f"Linv shape {tuple(Linv.shape)} != {(S, nb, bs, bs)}")
    if tuple(start_block.shape) != (nc,):
        raise ValueError(f"start_block shape {tuple(start_block.shape)} != {(nc,)}")


def int32_on(dev: torch.device, *tensors: torch.Tensor):
    """Index operands as contiguous int32 tensors on ``dev``."""
    return [t.to(device=dev, dtype=torch.int32).contiguous() for t in tensors]


@counted
def stepped_trsm_kernel(Linv: torch.Tensor, L: torch.Tensor, B: torch.Tensor,
                        start_block: torch.Tensor, bs: int, bm: int
                        ) -> torch.Tensor:
    """``Y = L⁻¹ B`` per subdomain for stepped, padded operands.

    Args:
      Linv: (S, nb, bs, bs) pre-inverted diagonal blocks of L.
      L: (S, n, n) lower factors, n a multiple of bs (identity-padded).
      B: (S, n, m) stepped right-hand sides, m a multiple of bm.
      start_block: (m // bm,) int first factor block of each stripe.

    Operands are float64 or float32, all of one dtype (f32 kernels
    accumulate in f32). CUDA tensors launch the kernel of their dtype,
    which takes bs a multiple of 8 up to 256 and bm a multiple of 8; CPU
    tensors run the plain version. ``stepped_trsm_kernel.launches`` counts
    launches, ``.launches_by_dtype`` them per dtype.
    """
    dev = check_dense_operands(Linv, L, B, start_block, bs, bm)
    if dev.type == "cpu":
        return stepped_trsm_plain(Linv, L, B, start_block, bs, bm)
    check_cuda_tiles(bs, bm)
    fn = build.function("stepped_trsm", f"stepped_trsm_{SUFFIX[B.dtype]}", 5,
                        5)
    S, n, m = B.shape
    (starts,) = int32_on(dev, start_block)
    Y = torch.empty_like(B)
    with torch.cuda.device(dev):
        err = fn(Linv.data_ptr(), L.data_ptr(), B.data_ptr(),
                 starts.data_ptr(), Y.data_ptr(), S, n, m, bs, bm,
                 stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_trsm kernel launch failed: CUDA error {err}")
    count_launch(stepped_trsm_kernel, B.dtype)
    return Y


@counted
def stepped_trsm_packed_kernel(Linv: torch.Tensor, values: torch.Tensor,
                               rowptr: torch.Tensor, colidx: torch.Tensor,
                               B: torch.Tensor, start_block: torch.Tensor,
                               bs: int, bm: int) -> torch.Tensor:
    """``Y = L⁻¹ B`` per subdomain against a packed factor stack.

    Args:
      Linv: (S, nb, bs, bs) pre-inverted diagonal blocks of L.
      values: (S, n_blocks, bs, bs) stored factor blocks, slots sorted by
        (row, col), diagonal identity-padded.
      rowptr: (nb + 1,) int row pointers into the slots (diagonal last).
      colidx: (n_blocks,) int block column of each slot.
      B: (S, n, m) stepped right-hand sides, padded to bs / bm multiples.
      start_block: (m // bm,) int first factor block of each stripe.

    CUDA tensors launch the kernel of their dtype (same dtypes and tile
    limits as :func:`stepped_trsm_kernel`); at f32 and bs > 16 it runs the
    column tiles of a stripe as one thread-block cluster (as many as the
    C launcher's ``stepped_trsm_cluster_tiles(bm)``) that loads each
    factor and Linv chunk once, and a launch the card refuses (no such
    cluster fits) raises. CPU tensors run the plain version.
    ``stepped_trsm_packed_kernel.launches`` counts launches,
    ``.launches_by_dtype`` them per dtype.
    """
    dev = check_packed_operands(Linv, values, rowptr, colidx, B, start_block,
                                bs, bm)
    if dev.type == "cpu":
        return stepped_trsm_packed_plain(Linv, values, rowptr, colidx, B,
                                         start_block, bs, bm)
    check_cuda_tiles(bs, bm)
    fn = build.function("stepped_trsm",
                        f"stepped_trsm_packed_{SUFFIX[B.dtype]}", 7, 6)
    S, n, m = B.shape
    starts, rp, ci = int32_on(dev, start_block, rowptr, colidx)
    Y = torch.empty_like(B)
    with torch.cuda.device(dev):
        err = fn(Linv.data_ptr(), values.data_ptr(), rp.data_ptr(),
                 ci.data_ptr(), B.data_ptr(), starts.data_ptr(), Y.data_ptr(),
                 S, n, m, bs, bm, values.shape[1], stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_trsm_packed kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(stepped_trsm_packed_kernel, B.dtype)
    return Y
