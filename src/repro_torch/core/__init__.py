"""Sparsity-utilizing assembly of Schur complement matrices (dual
operators) in domain decomposition methods — the port's core:

  * stepped-shape analysis and metadata: :mod:`repro_torch.core.stepped`
    (host numpy);
  * TRSM / SYRK variants batched over subdomains: :mod:`.trsm`, :mod:`.syrk`;
  * the assembly pipeline and its config: :mod:`.schur`.
"""
from repro_torch.core.schur import (
    SchurAssemblyConfig,
    assemble_schur,
    assembly_flops,
    make_assembler,
    schur_dense_baseline,
)
from repro_torch.core.stepped import (
    SteppedMeta,
    build_stepped_meta,
    column_pivots,
    shared_envelope,
    stepped_permutation,
)

__all__ = [
    "SchurAssemblyConfig",
    "SteppedMeta",
    "assemble_schur",
    "assembly_flops",
    "build_stepped_meta",
    "column_pivots",
    "make_assembler",
    "schur_dense_baseline",
    "shared_envelope",
    "stepped_permutation",
]
