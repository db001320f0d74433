"""Checks shared by the kernel wrappers: what the CUDA kernels accept, and
the launch counts they keep."""
from __future__ import annotations

import functools

import torch

TILE = 32  # column tile of the TRSM kernels (TN in csrc/stepped_trsm.cuh)
MIN_BS = 8  # the TRSM kernels take bs and bm multiples of it
MAX_BS = 256  # largest factor block: two 128-row passes of the TRSM core
# SYRK region edge of the fused kernels (FUSED_TILE in
# csrc/stepped_trsm_syrk.cu, whose launcher refuses an item list of another
# length than its own count): a SYRK item covers a group of 64 // bm
# stripes when bm < 64, else a 64 x 64 sub-tile of one stripe
FUSED_SYRK_TILE = 64
ALIGN = 16  # bytes: the CUDA kernels move operands in 16-byte copies
# the scalar types the kernels are built for, and the suffix of their C
# symbols (``stepped_trsm_f64``, ``stepped_trsm_f32``, ...)
SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def check_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every operand of one dtype the kernels are built for (SUFFIX),
    contiguous and on one device, and on CUDA 16-byte aligned (a view at an
    odd element offset is not); returns the device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    kinds = {t.dtype for t in tensors.values()}
    if len(kinds) != 1:
        raise TypeError(f"{name}: operands of several dtypes {kinds}; cast "
                        "them to one")
    dtype = kinds.pop()
    if dtype not in SUFFIX:
        raise TypeError(f"{name}: operands are {dtype}; this kernel takes "
                        "float64 or float32")
    for arg, t in tensors.items():
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
    """The TRSM kernels take bs a multiple of MIN_BS up to MAX_BS (every
    block size the reference's planner offers: 8 to 256) and bm a multiple
    of MIN_BS."""
    if bs % MIN_BS or not MIN_BS <= bs <= MAX_BS or bm % MIN_BS or bm < 1:
        raise ValueError(f"the CUDA kernel takes bs a multiple of {MIN_BS} "
                         f"up to {MAX_BS} and bm a multiple of {MIN_BS}; got "
                         f"bs={bs}, bm={bm}")


class counted:
    """Decorator of a kernel wrapper: keeps its launch counts per scalar
    type in ``launches_by_dtype`` ("f64", "f32"); ``launches`` is their
    sum. The wrapper counts a launch with :func:`count_launch`."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        reset_launches(self)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return sum(self.launches_by_dtype.values())


def count_launch(wrapper: counted, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel at ``dtype``."""
    wrapper.launches_by_dtype[SUFFIX[dtype]] += 1


def reset_launches(wrapper: counted) -> None:
    """Set ``wrapper``'s launch counts to zero."""
    wrapper.launches_by_dtype = {key: 0 for key in SUFFIX.values()}


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
