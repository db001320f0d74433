"""Stepped TRSM: the hand-written CUDA kernel and its plain version.

Solves ``L Y = B`` for a stepped B, batched over subdomains (paper §3.2).
The CUDA kernel (``csrc/stepped_trsm.cu``) replaces the TPU kernel
``repro/kernels/stepped_trsm.py::stepped_trsm_pallas``; its source note
says what bounds it on the card and what the design does about that.

:func:`stepped_trsm_kernel` is the wrapper the pipeline calls: for CUDA
tensors it launches the kernel (or raises), for CPU tensors it runs
:func:`stepped_trsm_plain`, the same schedule written in torch ops. There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import MAX_BS, TILE, check_operands, stream_of

__all__ = ["stepped_trsm_kernel", "stepped_trsm_plain"]


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


def _library():
    lib = build.load("stepped_trsm")
    fn = lib.stepped_trsm_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stepped_trsm_kernel(Linv: torch.Tensor, L: torch.Tensor, B: torch.Tensor,
                        start_block: torch.Tensor, bs: int, bm: int
                        ) -> torch.Tensor:
    """``Y = L⁻¹ B`` per subdomain for stepped, padded operands.

    Args:
      Linv: (S, nb, bs, bs) pre-inverted diagonal blocks of L.
      L: (S, n, n) lower factors, n a multiple of bs (identity-padded).
      B: (S, n, m) stepped right-hand sides, m a multiple of bm.
      start_block: (m // bm,) int first factor block of each stripe.

    CUDA tensors launch the kernel, which takes bs a multiple of 32 up to
    128 and bm a multiple of 32; CPU tensors run the plain version. Only
    float64 is accepted. ``stepped_trsm_kernel.launches`` counts launches.
    """
    dev = check_operands("stepped_trsm", Linv=Linv, L=L, B=B)
    S, n, m = B.shape
    nb, nc = n // bs, m // bm
    if n % bs or m % bm:
        raise ValueError("inputs must be padded to block multiples (see ops.py)")
    if tuple(L.shape) != (S, n, n):
        raise ValueError(f"L shape {tuple(L.shape)} != {(S, n, n)}")
    if tuple(Linv.shape) != (S, nb, bs, bs):
        raise ValueError(f"Linv shape {tuple(Linv.shape)} != {(S, nb, bs, bs)}")
    if tuple(start_block.shape) != (nc,):
        raise ValueError(f"start_block shape {tuple(start_block.shape)} != {(nc,)}")
    if dev.type == "cpu":
        return stepped_trsm_plain(Linv, L, B, start_block, bs, bm)
    if bs % TILE or bs > MAX_BS or bm % TILE:
        raise ValueError(f"the CUDA kernel takes bs a multiple of {TILE} up "
                         f"to {MAX_BS} and bm a multiple of {TILE}; got "
                         f"bs={bs}, bm={bm}")
    fn = _library()
    starts = start_block.to(device=dev, dtype=torch.int32).contiguous()
    Y = torch.empty_like(B)
    with torch.cuda.device(dev):
        err = fn(Linv.data_ptr(), L.data_ptr(), B.data_ptr(),
                 starts.data_ptr(), Y.data_ptr(), S, n, m, bs, bm,
                 stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_trsm kernel launch failed: CUDA error {err}")
    stepped_trsm_kernel.launches += 1
    return Y


stepped_trsm_kernel.launches = 0
