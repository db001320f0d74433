"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel lives in ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C
interface, built by :mod:`repro_torch.kernels.build` and loaded with
ctypes; shared device code in ``csrc/*.cuh``) and has a plain torch
version beside its wrapper. Every kernel (the stepped TRSM, dense and
packed, the stepped SYRK and the fused TRSM→SYRK, dense and packed) is
built at float64 and float32; a wrapper launches the kernel of its
operands' dtype and counts launches per dtype. Nothing here compiles or loads a kernel at import
time."""
from repro_torch.kernels.stepped_syrk import stepped_syrk_kernel, stepped_syrk_plain
from repro_torch.kernels.stepped_trsm import (
    stepped_trsm_kernel,
    stepped_trsm_packed_kernel,
    stepped_trsm_packed_plain,
    stepped_trsm_plain,
)
from repro_torch.kernels.stepped_trsm_syrk import (
    stepped_trsm_syrk_kernel,
    stepped_trsm_syrk_packed_kernel,
    stepped_trsm_syrk_packed_plain,
    stepped_trsm_syrk_plain,
)

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "stepped_syrk_kernel",
    "stepped_syrk_plain",
    "stepped_trsm_kernel",
    "stepped_trsm_packed_kernel",
    "stepped_trsm_packed_plain",
    "stepped_trsm_plain",
    "stepped_trsm_syrk_kernel",
    "stepped_trsm_syrk_packed_kernel",
    "stepped_trsm_syrk_packed_plain",
    "stepped_trsm_syrk_plain",
]


WRAPPERS = ("stepped_trsm", "stepped_trsm_packed", "stepped_syrk",
            "stepped_trsm_syrk", "stepped_trsm_syrk_packed")


def launch_counts() -> dict:
    """{kernel: {dtype: launches}} of this process since the last
    :func:`reset_launch_counts`, kernels and dtypes with none left out."""
    out = {}
    for name in WRAPPERS:
        counts = {d: c for d, c in
                  globals()[f"{name}_kernel"].launches_by_dtype.items() if c}
        if counts:
            out[name] = counts
    return out


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to zero."""
    from repro_torch.kernels._launch import reset_launches

    for name in WRAPPERS:
        reset_launches(globals()[f"{name}_kernel"])
