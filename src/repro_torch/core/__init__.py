"""Sparsity-utilizing assembly of Schur complement matrices (dual
operators) in domain decomposition methods — the port's core:

  * stepped-shape analysis and metadata: :mod:`repro_torch.core.stepped`
    (host numpy);
  * TRSM / SYRK variants batched over subdomains: :mod:`.trsm`, :mod:`.syrk`;
  * the assembly pipeline and its config: :mod:`.schur`;
  * the precision axis (storage, compute and solve dtypes):
    :mod:`.precision`;
  * the plan autotuner + content-addressed plan cache: :mod:`.autotune`
    (``plan`` façade below);
  * the stage graph (many Schur stages, one joint plan): :mod:`.stages`.
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
from repro_torch.core.autotune import (
    Plan,
    assembly_cost,
    enumerate_space,
    plan_assembly,
    plan_from_builder,
)
from repro_torch.core.stages import (
    GraphPlan,
    ResolvedStage,
    StageGraph,
    StageSpec,
)

# the façade: `from repro_torch.core import plan; plan(bt_pattern).cfg`
plan = plan_assembly

__all__ = [
    "GraphPlan",
    "Plan",
    "ResolvedStage",
    "SchurAssemblyConfig",
    "StageGraph",
    "StageSpec",
    "SteppedMeta",
    "assemble_schur",
    "assembly_cost",
    "assembly_flops",
    "build_stepped_meta",
    "column_pivots",
    "enumerate_space",
    "make_assembler",
    "plan",
    "plan_assembly",
    "plan_from_builder",
    "schur_dense_baseline",
    "shared_envelope",
    "stepped_permutation",
]
