"""Plain torch oracles for the stepped kernels (counterpart of
``repro.kernels.ref``): a full dense triangular solve and a full dense
product, so every zero-skipping trick is checked against arithmetic that
cannot share its bugs. Batched over a leading subdomain axis."""
from __future__ import annotations

import torch

__all__ = ["trsm_ref", "syrk_ref"]


def trsm_ref(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Y = L⁻¹ B via one dense triangular solve."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def syrk_ref(Y: torch.Tensor) -> torch.Tensor:
    """F = Yᵀ Y, full symmetric."""
    return Y.mT @ Y
