"""Checks shared by the kernel wrappers: what the CUDA kernels accept."""
from __future__ import annotations

import torch

TILE = 32  # column tile of both kernels (TN / T in csrc/*.cu)
MAX_BS = 128  # largest factor block the TRSM accumulator holds


def check_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every operand f64, contiguous and on one device; returns it."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    for arg, t in tensors.items():
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: {arg} is {t.dtype}; this kernel takes "
                            "float64 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
