"""The precision axis of the port's FETI pipeline (counterpart of
``repro.core.precision``, on torch dtypes).

Three dtypes meet in a reduced-precision solve:

  * the **storage dtype** of the persistent stacks (factor, F̃, S_b, the
    lumped K, B̃ᵀ): what :func:`canonical_dtype` normalizes;
  * the **compute dtype** of the factorization, TRSM and SYRK: the storage
    dtype itself, except bf16, whose prep runs at f32 (torch has no bf16
    Cholesky or triangular solve, and the kernels accumulate sub-f64
    inputs in f32);
  * the **solve dtype** of the PCPG vectors: f64 whenever refinement is
    on, else the storage dtype.

Dtype spellings accepted everywhere: ``"f64"``/``"f32"``/``"bf16"``, the
torch dtypes ``torch.float64``/``torch.float32``/``torch.bfloat16``, and
python ``float`` (f64).
"""
from __future__ import annotations

from typing import Any

import torch

__all__ = [
    "SUPPORTED_DTYPES",
    "canonical_dtype",
    "dtype_name",
    "compute_dtype",
    "solve_dtype",
    "eps",
    "itemsize",
    "tol_floor",
    "default_refine_steps",
]

_NAME_TO_DTYPE = {"f64": torch.float64, "f32": torch.float32,
                  "bf16": torch.bfloat16}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

SUPPORTED_DTYPES = tuple(_NAME_TO_DTYPE)


def canonical_dtype(dtype: Any) -> torch.dtype:
    """Normalize an accepted dtype spelling to its torch dtype; anything
    outside :data:`SUPPORTED_DTYPES` raises ``ValueError``."""
    if isinstance(dtype, str) and dtype in _NAME_TO_DTYPE:
        return _NAME_TO_DTYPE[dtype]
    if dtype is float:
        return torch.float64
    if isinstance(dtype, torch.dtype) and dtype in _DTYPE_TO_NAME:
        return dtype
    raise ValueError(f"unsupported assembly dtype {dtype!r}; supported: "
                     f"{SUPPORTED_DTYPES}")


def dtype_name(dtype: Any) -> str:
    """Short name of a dtype: "f64" | "f32" | "bf16"."""
    return _DTYPE_TO_NAME[canonical_dtype(dtype)]


def compute_dtype(dtype: Any) -> torch.dtype:
    """The dtype the factorization/TRSM/SYRK math runs in: the storage
    dtype itself, except bf16, which runs at f32."""
    dt = canonical_dtype(dtype)
    return torch.float32 if dt == torch.bfloat16 else dt


def solve_dtype(dtype: Any, refine_steps: int) -> torch.dtype:
    """The dtype of the PCPG vectors: f64 whenever refinement is on, else
    the storage dtype itself."""
    dt = canonical_dtype(dtype)
    if refine_steps > 0 and dt != torch.float64:
        return torch.float64
    return dt


def eps(dtype: Any) -> float:
    """Machine epsilon of a (canonicalized) dtype as a python float."""
    return float(torch.finfo(canonical_dtype(dtype)).eps)


def itemsize(dtype: Any) -> int:
    """Bytes per element of the dtype."""
    return canonical_dtype(dtype).itemsize


def tol_floor(dtype: Any, factor: float = 50.0) -> float:
    """The smallest relative PCPG tolerance worth asking of an operator in
    ``dtype``: ``factor * eps`` (f64 ~1.1e-14, f32 ~6e-6, bf16 ~0.4). CG's
    recursive residual stagnates at a modest multiple of eps."""
    return factor * eps(dtype)


def default_refine_steps(dtype: Any) -> int:
    """Refinement steps when ``FetiConfig.refine`` is None: none for f64
    stacks, 2 interior-solve refinement steps for reduced ones."""
    return 0 if canonical_dtype(dtype) == torch.float64 else 2
