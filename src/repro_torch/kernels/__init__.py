"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel lives in ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C
interface, built by :mod:`repro_torch.kernels.build` and loaded with
ctypes) and has a plain torch version beside its wrapper. Nothing here
compiles or loads a kernel at import time."""
from repro_torch.kernels.stepped_syrk import stepped_syrk_kernel, stepped_syrk_plain
from repro_torch.kernels.stepped_trsm import stepped_trsm_kernel, stepped_trsm_plain

__all__ = [
    "stepped_syrk_kernel",
    "stepped_syrk_plain",
    "stepped_trsm_kernel",
    "stepped_trsm_plain",
]
