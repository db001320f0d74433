"""Stepped SYRK: the hand-written CUDA kernel and its plain version.

Computes the lower block triangle of ``F = Yᵀ Y`` over ``bm × bm`` tiles,
batched over subdomains (paper §3.3): tile (i, j ≤ i) sums the Y rows from
stripe i's start block on, for any Y. The CUDA kernel
(``csrc/stepped_syrk.cu``) replaces the TPU kernel
``repro/kernels/stepped_syrk.py::stepped_syrk_pallas``, at float64 (FP64
tensor cores) and at float32 (3xTF32 on the TF32 tensor cores,
accumulating in f32, as the TPU kernel does). A block covers a 128 × 128
group of tiles when bm < 128 and masks each Y column at its own stripe's
start, which gives each tile exactly its own terms because the start
blocks are non-decreasing, as the stepped metadata makes them.

:func:`stepped_syrk_kernel` launches the kernel for CUDA tensors (or
raises) and runs :func:`stepped_syrk_plain` for CPU tensors. Upper tiles
come out as exact zeros either way: ``ops._mirror_lower`` adds the
transposed strict-lower part to the whole tile array.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (
    MIN_BS,
    SUFFIX,
    check_operands,
    count_launch,
    counted,
    stream_of,
)

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


@counted
def stepped_syrk_kernel(Y: torch.Tensor, start_block: torch.Tensor, bs: int,
                        bm: int) -> torch.Tensor:
    """Lower block triangle of ``Y_sᵀ Y_s`` per subdomain.

    Args:
      Y: (S, n, m) stepped TRSM solutions, n a multiple of bs, m of bm.
      start_block: (m // bm,) int first contributing row block per stripe,
        non-decreasing (the CUDA kernel relies on it).

    Y is float64 or float32. CUDA tensors launch the kernel of its dtype
    (bm a multiple of 8, Y 16-byte aligned); CPU tensors run the plain
    version. ``stepped_syrk_kernel.launches`` counts launches,
    ``.launches_by_dtype`` them per dtype.
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
    if bm % MIN_BS:
        raise ValueError(f"the CUDA kernel takes bm a multiple of {MIN_BS}; "
                         f"got bm={bm}")
    fn = build.function("stepped_syrk", f"stepped_syrk_{SUFFIX[Y.dtype]}", 3,
                        5)
    starts = start_block.to(device=dev, dtype=torch.int32).contiguous()
    F = torch.zeros((S, m, m), dtype=Y.dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(Y.data_ptr(), starts.data_ptr(), F.data_ptr(), S, n, m, bs,
                 bm, stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_syrk kernel launch failed: CUDA error {err}")
    count_launch(stepped_syrk_kernel, Y.dtype)
    return F
