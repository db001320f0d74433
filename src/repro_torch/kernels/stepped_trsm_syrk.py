"""Fused stepped TRSM→SYRK: the hand-written CUDA kernels and their plain
versions.

Computes the lower block triangle of ``F = (L⁻¹B)ᵀ(L⁻¹B)`` over
``bm × bm`` tiles in one launch, batched over subdomains, against a dense
or a packed factor. The CUDA kernels (``csrc/stepped_trsm_syrk.cu``)
replace the TPU kernels
``repro/kernels/stepped_trsm_syrk.py::stepped_trsm_syrk_pallas`` and
``::stepped_trsm_syrk_packed_pallas``; the source note says how the CUDA
version orders its work (a cost-ordered item list drawn through one atomic
ticket, :mod:`repro_torch.kernels.schedule`) and makes readiness explicit
(a flag per solved column tile), where the TPU relies on its sequential
grid. The item list is an operand: ``kernels/ops.py`` builds it from host
values beside the start blocks and caches it with the plan
(:func:`repro_torch.kernels.schedule.fused_work_order_on`).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version — the stepped TRSM's then the stepped SYRK's schedule — for
CPU tensors. Upper tiles come out as exact zeros either way, as
``ops._mirror_lower`` needs. The kernels are built at float64 and at
float32 (products 3xTF32 on the TF32 tensor cores, accumulating in f32,
as the TPU kernel accumulates sub-f64 inputs; bf16 storage runs its prep
at f32): a wrapper
launches the kernel of its operands' dtype and counts launches per dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (
    SUFFIX,
    TILE,
    check_cuda_tiles,
    count_launch,
    counted,
    stream_of,
)
from repro_torch.kernels.schedule import fused_item_count
from repro_torch.kernels.stepped_syrk import stepped_syrk_plain
from repro_torch.kernels.stepped_trsm import (
    check_dense_operands,
    check_packed_operands,
    int32_on,
    stepped_trsm_packed_plain,
    stepped_trsm_plain,
)

__all__ = [
    "stepped_trsm_syrk_kernel",
    "stepped_trsm_syrk_plain",
    "stepped_trsm_syrk_packed_kernel",
    "stepped_trsm_syrk_packed_plain",
]


def stepped_trsm_syrk_plain(Linv: torch.Tensor, L: torch.Tensor,
                            B: torch.Tensor, start_block: torch.Tensor,
                            bs: int, bm: int) -> torch.Tensor:
    """Every stripe solved into Y (:func:`stepped_trsm_plain`), then the
    lower tiles contracted from it (:func:`stepped_syrk_plain`)."""
    Y = stepped_trsm_plain(Linv, L, B, start_block, bs, bm)
    return stepped_syrk_plain(Y, start_block, bs, bm)


def stepped_trsm_syrk_packed_plain(Linv: torch.Tensor, values: torch.Tensor,
                                   rowptr: torch.Tensor, colidx: torch.Tensor,
                                   B: torch.Tensor, start_block: torch.Tensor,
                                   bs: int, bm: int) -> torch.Tensor:
    """:func:`stepped_trsm_syrk_plain` with the packed forward
    substitution (:func:`stepped_trsm_packed_plain`)."""
    Y = stepped_trsm_packed_plain(Linv, values, rowptr, colidx, B,
                                  start_block, bs, bm)
    return stepped_syrk_plain(Y, start_block, bs, bm)


def _outputs(B: torch.Tensor):
    """The Y scratch (written whole by the TRSM items), the zeroed F and
    the sync words (ticket and one ready flag per column tile; the launcher
    zeroes them)."""
    S, n, m = B.shape
    return (torch.empty_like(B), B.new_zeros((S, m, m)),
            torch.empty(1 + S * -(-m // TILE), dtype=torch.int32,
                        device=B.device))


def _check_order(order, B: torch.Tensor, bm: int) -> None:
    """The item list a CUDA launch needs: int32 on B's device, every item
    once (the launcher refuses another length)."""
    S, _, m = B.shape
    if order is None:
        raise ValueError("the fused CUDA kernel needs its item list: pass "
                         "order= from kernels.schedule.fused_work_order_on")
    want = (fused_item_count(S, m, bm),)
    if order.dtype != torch.int32 or order.device != B.device \
            or tuple(order.shape) != want:
        raise ValueError(f"order must be int32 of shape {want} on "
                         f"{B.device}; got {order.dtype} "
                         f"{tuple(order.shape)} on {order.device}")


@counted
def stepped_trsm_syrk_kernel(Linv: torch.Tensor, L: torch.Tensor,
                             B: torch.Tensor, start_block: torch.Tensor,
                             bs: int, bm: int,
                             order: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Lower block triangle of ``(L_s⁻¹ B_s)ᵀ (L_s⁻¹ B_s)`` per subdomain.

    Operands as :func:`repro_torch.kernels.stepped_trsm.stepped_trsm_kernel`;
    returns (S, m, m) with exact zeros in the upper tiles. CUDA tensors
    launch the kernel (bs a multiple of 8 up to 256, bm a multiple of 8)
    and need ``order``, its item list
    (:func:`repro_torch.kernels.schedule.fused_work_order_on` of the same
    start blocks); CPU tensors run the plain version, which needs no list.
    Operands are float64 or float32, all of one dtype (the f32 kernel
    accumulates in f32, and Y and F are f32).
    ``stepped_trsm_syrk_kernel.launches`` counts launches,
    ``.launches_by_dtype`` them per dtype.
    """
    dev = check_dense_operands(Linv, L, B, start_block, bs, bm)
    if dev.type == "cpu":
        return stepped_trsm_syrk_plain(Linv, L, B, start_block, bs, bm)
    check_cuda_tiles(bs, bm)
    _check_order(order, B, bm)
    fn = build.function("stepped_trsm_syrk",
                        f"stepped_trsm_syrk_{SUFFIX[B.dtype]}", 8, 6)
    S, n, m = B.shape
    (starts,) = int32_on(dev, start_block)
    Y, F, sync = _outputs(B)
    with torch.cuda.device(dev):
        err = fn(Linv.data_ptr(), L.data_ptr(), B.data_ptr(),
                 starts.data_ptr(), order.data_ptr(), sync.data_ptr(),
                 Y.data_ptr(), F.data_ptr(), S, n, m, bs, bm, order.numel(),
                 stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_trsm_syrk kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(stepped_trsm_syrk_kernel, B.dtype)
    return F


@counted
def stepped_trsm_syrk_packed_kernel(Linv: torch.Tensor, values: torch.Tensor,
                                    rowptr: torch.Tensor, colidx: torch.Tensor,
                                    B: torch.Tensor, start_block: torch.Tensor,
                                    bs: int, bm: int,
                                    order: torch.Tensor | None = None
                                    ) -> torch.Tensor:
    """:func:`stepped_trsm_syrk_kernel` against a packed factor stack,
    operands as
    :func:`repro_torch.kernels.stepped_trsm.stepped_trsm_packed_kernel`;
    on CUDA ``order`` is the item list built with the CSR index too.
    Float64 or float32, as :func:`stepped_trsm_syrk_kernel`.
    ``stepped_trsm_syrk_packed_kernel.launches`` counts launches,
    ``.launches_by_dtype`` them per dtype."""
    dev = check_packed_operands(Linv, values, rowptr, colidx, B, start_block,
                                bs, bm)
    if dev.type == "cpu":
        return stepped_trsm_syrk_packed_plain(Linv, values, rowptr, colidx, B,
                                              start_block, bs, bm)
    check_cuda_tiles(bs, bm)
    _check_order(order, B, bm)
    fn = build.function("stepped_trsm_syrk",
                        f"stepped_trsm_syrk_packed_{SUFFIX[B.dtype]}", 10, 7)
    S, n, m = B.shape
    starts, rp, ci = int32_on(dev, start_block, rowptr, colidx)
    Y, F, sync = _outputs(B)
    with torch.cuda.device(dev):
        err = fn(Linv.data_ptr(), values.data_ptr(), rp.data_ptr(),
                 ci.data_ptr(), B.data_ptr(), starts.data_ptr(),
                 order.data_ptr(), sync.data_ptr(), Y.data_ptr(),
                 F.data_ptr(), S, n, m, bs, bm, values.shape[1], order.numel(),
                 stream_of(dev))
    if err:
        raise RuntimeError(f"stepped_trsm_syrk_packed kernel launch failed: "
                           f"CUDA error {err}")
    count_launch(stepped_trsm_syrk_packed_kernel, B.dtype)
    return F
