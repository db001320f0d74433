"""The sparsity-utilizing Schur complement assembly pipeline (paper §3),
batched over subdomains (counterpart of ``repro.core.schur``).

Assembles the dense local dual operators

    F̃ = B̃ L⁻ᵀ L⁻¹ B̃ᵀ = (L⁻¹B̃ᵀ)ᵀ (L⁻¹B̃ᵀ) = Yᵀ Y    (paper eq. 14)

from the Cholesky factors ``L`` and the gluing blocks ``B̃ᵀ``:

  1. column-permute B̃ᵀ into the *stepped* shape (stepped.py),
  2. TRSM with RHS- or factor-splitting (trsm.py) — or the hand-written
     stepped TRSM kernel,
  3. SYRK with input- or output-splitting (syrk.py) — or the hand-written
     stepped SYRK kernel,
  4. permute the resulting SC back to the original multiplier order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import syrk as syrk_mod
from repro_torch.core import trsm as trsm_mod
from repro_torch.core.stepped import SteppedMeta

__all__ = [
    "SchurAssemblyConfig",
    "make_assembler",
    "assemble_schur",
    "schur_dense_baseline",
    "assembly_flops",
]

TRSM_VARIANTS = ("dense", "rhs_split", "factor_split")
SYRK_VARIANTS = ("dense", "input_split", "output_split")


@dataclasses.dataclass(frozen=True)
class SchurAssemblyConfig:
    """Configuration of the SC assembly (paper §3 / Table 1).

    Attributes:
      trsm_variant: "dense" (baseline) | "rhs_split" | "factor_split".
      syrk_variant: "dense" (baseline) | "input_split" | "output_split".
      block_size: factor row-block size (paper's "S").
      rhs_block_size: RHS column-block size (defaults to block_size).
      prune: skip structurally-zero factor blocks in the factor-split GEMM
        updates (needs a block fill mask; paper's "pruning").
      use_kernels: dispatch every non-dense TRSM/SYRK variant to the
        hand-written stepped kernels (:mod:`repro_torch.kernels`); the
        counterpart of ``repro``'s ``use_pallas``.
      fused: the fused TRSM→SYRK kernel — ROADMAP item B4, not ported.
      storage: factor storage; only "dense" here ("packed" is ROADMAP A9).
    """

    trsm_variant: str = "factor_split"
    syrk_variant: str = "input_split"
    block_size: int = 128
    rhs_block_size: Optional[int] = None
    prune: bool = True
    use_kernels: bool = False
    fused: bool = False
    storage: str = "dense"

    def __post_init__(self):
        if self.trsm_variant not in TRSM_VARIANTS:
            raise ValueError(f"trsm_variant must be one of {TRSM_VARIANTS}")
        if self.syrk_variant not in SYRK_VARIANTS:
            raise ValueError(f"syrk_variant must be one of {SYRK_VARIANTS}")
        if self.fused:
            raise NotImplementedError(
                "the fused TRSM→SYRK kernel is ROADMAP item B4")
        if self.storage == "packed":
            raise NotImplementedError("packed factor storage is ROADMAP item A9")
        if self.storage != "dense":
            raise ValueError(f"unknown storage {self.storage!r}")

    @property
    def rhs_bs(self) -> int:
        return self.rhs_block_size or self.block_size

    @property
    def is_dense_baseline(self) -> bool:
        """True when no variant exploits the stepped order — the column
        permutation is then a mathematical no-op and is skipped."""
        return self.trsm_variant == "dense" and self.syrk_variant == "dense"


def _trsm(L, Bp, meta, cfg, block_mask):
    if cfg.use_kernels and cfg.trsm_variant != "dense":
        from repro_torch.kernels import ops as kops  # lazy: avoid import cycle

        return kops.stepped_trsm(L, Bp, meta)
    if cfg.trsm_variant == "dense":
        return trsm_mod.trsm_dense(L, Bp)
    if cfg.trsm_variant == "rhs_split":
        return trsm_mod.trsm_rhs_split(L, Bp, meta)
    return trsm_mod.trsm_factor_split(
        L, Bp, meta, block_mask=block_mask if cfg.prune else None)


def _syrk(Y, meta, cfg):
    if cfg.use_kernels and cfg.syrk_variant != "dense":
        from repro_torch.kernels import ops as kops  # lazy: avoid import cycle

        return kops.stepped_syrk(Y, meta)
    if cfg.syrk_variant == "dense":
        return syrk_mod.syrk_dense(Y)
    if cfg.syrk_variant == "input_split":
        return syrk_mod.syrk_input_split(Y, meta)
    return syrk_mod.syrk_output_split(Y, meta)


def make_assembler(
    meta: SteppedMeta,
    cfg: SchurAssemblyConfig,
    block_mask: Optional[np.ndarray] = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build the assembler for one sparsity pattern.

    Returns ``assemble(L, Bt) -> F`` where ``L`` is (S, n, n), ``Bt`` is
    (S, n, m) in the ORIGINAL column order and ``F`` the (S, m, m) dense SCs
    in the original order; ``meta`` is shared by all S.
    """
    if cfg.is_dense_baseline:
        # dense TRSM + dense SYRK never look at the stepped metadata, and
        # F = (L⁻¹Bᵀ)ᵀL⁻¹Bᵀ is permutation-equivariant: skip the permute
        def assemble_dense(L, Bt):
            return _syrk(_trsm(L, Bt, meta, cfg, block_mask), meta, cfg)

        return assemble_dense

    def assemble(L, Bt):
        perm = torch.as_tensor(meta.perm, device=Bt.device)
        inv = torch.as_tensor(meta.inv_perm, device=Bt.device)
        Fp = _syrk(_trsm(L, Bt[:, :, perm], meta, cfg, block_mask), meta, cfg)
        # permute back: F[i, j] = Fp[inv[i], inv[j]]
        return Fp[:, inv][:, :, inv]

    return assemble


def assemble_schur(L: torch.Tensor, Bt: torch.Tensor, meta: SteppedMeta,
                   cfg: SchurAssemblyConfig,
                   block_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """One-shot convenience wrapper around :func:`make_assembler`."""
    return make_assembler(meta, cfg, block_mask)(L, Bt)


def schur_dense_baseline(L: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
    """The original algorithm (paper §3.1): dense TRSM + dense SYRK, no
    permutation, no splitting."""
    return syrk_mod.syrk_dense(trsm_mod.trsm_dense(L, Bt))


def assembly_flops(meta: SteppedMeta, cfg: SchurAssemblyConfig) -> dict:
    """FLOP model of one subdomain's assembly under ``cfg`` (lower-triangle
    SYRK)."""
    trsm = {
        "dense": meta.flops_trsm_dense,
        "rhs_split": meta.flops_trsm_rhs_split,
        "factor_split": meta.flops_trsm_factor_split,
    }[cfg.trsm_variant]()
    syrk = {
        "dense": meta.flops_syrk_dense,
        "input_split": meta.flops_syrk_input_split,
        "output_split": meta.flops_syrk_output_split,
    }[cfg.syrk_variant]()
    return {"trsm": trsm, "syrk": syrk, "total": trsm + syrk}
