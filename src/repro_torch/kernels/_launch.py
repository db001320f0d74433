"""Checks shared by the kernel wrappers: what the CUDA kernels accept."""
from __future__ import annotations

import torch

TILE = 32  # column tile of the TRSM kernels (TN in csrc/stepped_trsm.cuh)
MAX_BS = 128  # largest factor block the TRSM accumulator holds
# SYRK sub-tile edge of the fused kernels (FUSED_TILE in
# csrc/stepped_trsm_syrk.cu, whose launcher refuses an item list of another
# length than its own count)
FUSED_SYRK_TILE = 64
ALIGN = 16  # bytes: the CUDA kernels move operands in 16-byte copies


def check_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every operand f64, contiguous and on one device, and on CUDA
    16-byte aligned (a view at an odd element offset is not); returns the
    device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    for arg, t in tensors.items():
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: {arg} is {t.dtype}; this kernel takes "
                            "float64 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.is_cuda and t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {arg} must start {ALIGN}-byte aligned "
                             "on CUDA")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def check_cuda_tiles(bs: int, bm: int) -> None:
    """The TRSM kernels take bs a multiple of TILE up to MAX_BS and bm a
    multiple of TILE."""
    if bs % TILE or bs > MAX_BS or bm % TILE:
        raise ValueError(f"the CUDA kernel takes bs a multiple of {TILE} up "
                         f"to {MAX_BS} and bm a multiple of {TILE}; got "
                         f"bs={bs}, bm={bm}")


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
