"""Structured telemetry of the port (spans, metrics, timing); counterpart
of ``repro.obs``:

  * :mod:`repro_torch.obs.trace` — nested span tracer (context-manager API,
    device sync at span close, Chrome-trace/JSONL export, cross-module
    propagation via :func:`use_tracer`/:func:`current_tracer`)
  * :mod:`repro_torch.obs.metrics` — process-global counters/gauges
    (plan-cache hits and misses, PCPG solves, iterations, defect-correction
    outers and tolerance clamps, device bytes by stack, dtype and stage)
  * :mod:`repro_torch.obs.timing` — THE synchronized timing helper of the
    autotuner's measured refinement
  * :mod:`repro_torch.obs.validate` — schema validation of the exported
    artifacts (``python -m repro_torch.obs.validate out.json``; not
    imported here, so that ``-m`` runs it as a fresh module)

:class:`Telemetry` is what ``FetiSolver.telemetry`` holds;
``FetiSolver.report()`` and ``FetiSolver.amortization_report()`` read it.
"""
from __future__ import annotations

from repro_torch.obs import metrics
from repro_torch.obs.timing import min_time, synchronize, time_call, timed_reps
from repro_torch.obs.trace import (
    TRACE_SCHEMA_VERSION,
    Span,
    Tracer,
    annotation,
    current_tracer,
    use_tracer,
)

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "Span",
    "Tracer",
    "Telemetry",
    "annotation",
    "current_tracer",
    "use_tracer",
    "metrics",
    "synchronize",
    "timed_reps",
    "min_time",
    "time_call",
]


class Telemetry:
    """One solver's telemetry: a span tracer plus the process-global
    metrics registry. Held by :class:`repro_torch.feti.solver.FetiSolver`
    as ``solver.telemetry``; ``disable()`` turns the spans into no-ops
    without touching the counters."""

    def __init__(self, enabled: bool = True):
        self.tracer = Tracer(enabled=enabled)
        self.metrics = metrics.REGISTRY

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def enable(self) -> None:
        self.tracer.enabled = True

    def disable(self) -> None:
        self.tracer.enabled = False
