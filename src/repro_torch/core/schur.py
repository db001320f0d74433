"""The sparsity-utilizing Schur complement assembly pipeline (paper §3),
batched over subdomains (counterpart of ``repro.core.schur``).

Assembles the dense local dual operators

    F̃ = B̃ L⁻ᵀ L⁻¹ B̃ᵀ = (L⁻¹B̃ᵀ)ᵀ (L⁻¹B̃ᵀ) = Yᵀ Y    (paper eq. 14)

from the Cholesky factors ``L`` and the gluing blocks ``B̃ᵀ``:

  1. column-permute B̃ᵀ into the *stepped* shape (stepped.py),
  2. TRSM with RHS- or factor-splitting (trsm.py) — or the hand-written
     stepped TRSM kernel (dense or packed factor),
  3. SYRK with input- or output-splitting (syrk.py) — or the hand-written
     stepped SYRK kernel; with ``fused=True`` steps 2-3 are one
     hand-written TRSM→SYRK kernel,
  4. permute the resulting SC back to the original multiplier order.

The factor is a dense (S, n, n) stack or a packed
:class:`~repro_torch.sparse.packed.PackedBlocks` stack (``storage``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import syrk as syrk_mod
from repro_torch.core import trsm as trsm_mod
from repro_torch.core.stepped import SteppedMeta
from repro_torch.sparse.packed import (
    PackedBlocks,
    pack_factor,
    packed_block_index_for,
)

__all__ = [
    "SchurAssemblyConfig",
    "make_assembler",
    "assemble_schur",
    "schur_dense_baseline",
    "assembly_flops",
]

TRSM_VARIANTS = ("dense", "rhs_split", "factor_split")
SYRK_VARIANTS = ("dense", "input_split", "output_split")
STORAGE_VARIANTS = ("dense", "packed")


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
      fused: run TRSM→SYRK as ONE hand-written kernel
        (``kernels/stepped_trsm_syrk.py``). Requires ``use_kernels``; the
        ``trsm_variant``/``syrk_variant`` fields are then ignored (the
        kernel's schedule is rhs-split × output-split by construction).
      storage: factor storage, "dense" (an (S, n, n) stack) or "packed"
        (a :class:`~repro_torch.sparse.packed.PackedBlocks`: the symbolic
        fill mask is the layout). Packed storage is native for
        ``factor_split`` and the kernels; the "dense"/"rhs_split" TRSM
        variants unpack the factor transiently.
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
        if self.storage not in STORAGE_VARIANTS:
            raise ValueError(f"storage must be one of {STORAGE_VARIANTS}")
        if self.fused and not self.use_kernels:
            raise ValueError("fused=True is the hand-written TRSM→SYRK "
                             "kernel and requires use_kernels=True")

    @property
    def rhs_bs(self) -> int:
        return self.rhs_block_size or self.block_size

    @property
    def is_dense_baseline(self) -> bool:
        """True when no variant exploits the stepped order — the column
        permutation is then a mathematical no-op and is skipped."""
        return (self.trsm_variant == "dense" and self.syrk_variant == "dense"
                and not self.fused)


def _coerce_factor(L, meta, cfg, block_mask):
    """Align the factor's representation with ``cfg.storage``: packed
    configs pack a dense factor (index from the block mask, or the full
    lower triangle without one); dense configs unpack a packed factor.
    Callers that preprocess in the configured layout never pay it."""
    packed = isinstance(L, PackedBlocks)
    if cfg.storage == "packed" and not packed:
        return pack_factor(L, packed_block_index_for(block_mask, meta.n,
                                                     meta.block_size))
    if cfg.storage == "dense" and packed:
        return L.unpack()
    return L


def _trsm(L, Bp, meta, cfg, block_mask):
    packed = isinstance(L, PackedBlocks)
    if cfg.use_kernels and cfg.trsm_variant != "dense":
        from repro_torch.kernels import ops as kops  # lazy: avoid import cycle

        if packed:
            return kops.stepped_trsm_packed(L, Bp, meta)
        return kops.stepped_trsm(L, Bp, meta)
    if packed and cfg.trsm_variant == "factor_split":
        # pruning is structural in packed storage: absent blocks don't exist
        return trsm_mod.trsm_factor_split_packed(L, Bp, meta)
    if packed:
        # dense/rhs_split TRSM need the trailing subfactor as one array
        L = L.unpack()
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

    Returns ``assemble(L, Bt) -> F`` where ``L`` is an (S, n, n) factor
    stack or a packed one (coerced to ``cfg.storage``), ``Bt`` is
    (S, n, m) in the ORIGINAL column order and ``F`` the (S, m, m) dense SCs
    in the original order; ``meta`` is shared by all S.
    """
    if cfg.is_dense_baseline:
        # dense TRSM + dense SYRK never look at the stepped metadata, and
        # F = (L⁻¹Bᵀ)ᵀL⁻¹Bᵀ is permutation-equivariant: skip the permute
        def assemble_dense(L, Bt):
            Lc = _coerce_factor(L, meta, cfg, block_mask)
            return _syrk(_trsm(Lc, Bt, meta, cfg, block_mask), meta, cfg)

        return assemble_dense

    def assemble(L, Bt):
        perm = torch.as_tensor(meta.perm, device=Bt.device)
        inv = torch.as_tensor(meta.inv_perm, device=Bt.device)
        Bp = Bt[:, :, perm]
        Lc = _coerce_factor(L, meta, cfg, block_mask)
        if cfg.fused:
            from repro_torch.kernels import ops as kops  # lazy: avoid import cycle

            Fp = kops.stepped_trsm_syrk(Lc, Bp, meta)
        else:
            Fp = _syrk(_trsm(Lc, Bp, meta, cfg, block_mask), meta, cfg)
        # permute back: F[i, j] = Fp[inv[i], inv[j]]
        return Fp[:, inv][:, :, inv]

    return assemble


def assemble_schur(L, Bt: torch.Tensor, meta: SteppedMeta,
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
    if cfg.fused:
        # the fused kernel's schedule: per-stripe forward substitution with
        # the stepped skip (= rhs_split flops) + output-tile contraction
        # from each stripe's start (= output_split flops)
        trsm = meta.flops_trsm_rhs_split()
        syrk = meta.flops_syrk_output_split()
        return {"trsm": trsm, "syrk": syrk, "total": trsm + syrk}
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
