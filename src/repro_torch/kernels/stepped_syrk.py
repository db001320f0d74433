"""Stepped SYRK: the hand-written CUDA kernel and its plain version.

Computes the lower block triangle of ``F = Yᵀ Y`` over ``bm × bm`` tiles,
batched over subdomains (paper §3.3). The CUDA kernel
(``csrc/stepped_syrk.cu``) replaces the TPU kernel
``repro/kernels/stepped_syrk.py::stepped_syrk_pallas``.

:func:`stepped_syrk_kernel` launches the kernel for CUDA tensors (or
raises) and runs :func:`stepped_syrk_plain` for CPU tensors. Upper tiles
come out as exact zeros either way: ``ops._mirror_lower`` adds the
transposed strict-lower part to the whole tile array.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import TILE, check_operands, stream_of

__all__ = ["stepped_syrk_kernel", "stepped_syrk_plain"]


def stepped_syrk_plain(Y: torch.Tensor, start_block: torch.Tensor, bs: int,
                       bm: int) -> torch.Tensor:
    """The TPU kernel's schedule in torch ops, batched over S: tile row i
    (its tiles ``j <= i`` in one product) reduces over factor rows from
    ``start_block[i]`` on; upper tiles stay zero."""
    S, n, m = Y.shape
    F = Y.new_zeros((S, m, m))
    for i, start in enumerate(start_block.tolist()):
        k0 = start * bs
        Yi = Y[:, k0:, i * bm:(i + 1) * bm]
        F[:, i * bm:(i + 1) * bm, :(i + 1) * bm] = Yi.mT @ Y[:, k0:, :(i + 1) * bm]
    return F


def _library():
    lib = build.load("stepped_syrk")
    fn = lib.stepped_syrk_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stepped_syrk_kernel(Y: torch.Tensor, start_block: torch.Tensor, bs: int,
                        bm: int) -> torch.Tensor:
    """Lower block triangle of ``Y_sᵀ Y_s`` per subdomain.

    Args:
      Y: (S, n, m) stepped TRSM solutions, n a multiple of bs, m of bm.
      start_block: (m // bm,) int first contributing row block per stripe.

    CUDA tensors launch the kernel (bm a multiple of 32); CPU tensors run
    the plain version. Only float64 is accepted.
    ``stepped_syrk_kernel.launches`` counts launches.
    """
    dev = check_operands("stepped_syrk", Y=Y)
    S, n, m = Y.shape
    if n % bs or m % bm:
        raise ValueError("inputs must be padded to block multiples (see ops.py)")
    if tuple(start_block.shape) != (m // bm,):
        raise ValueError(f"start_block shape {tuple(start_block.shape)} != "
                         f"{(m // bm,)}")
    if dev.type == "cpu":
        return stepped_syrk_plain(Y, start_block, bs, bm)
    if bm % TILE:
        raise ValueError(f"the CUDA kernel takes bm a multiple of {TILE}; "
                         f"got bm={bm}")
    fn = _library()
    starts = start_block.to(device=dev, dtype=torch.int32).contiguous()
    F = torch.zeros((S, m, m), dtype=Y.dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(Y.data_ptr(), starts.data_ptr(), F.data_ptr(), S, n, m, bs,
                 bm, stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_syrk kernel launch failed: CUDA error {err}")
    stepped_syrk_kernel.launches += 1
    return F


stepped_syrk_kernel.launches = 0
