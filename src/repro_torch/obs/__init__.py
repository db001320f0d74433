"""Structured telemetry of the port (spans, metrics, timing); counterpart
of ``repro.obs``:

  * :mod:`repro_torch.obs.trace` — nested span tracer (context-manager API,
    device sync at span close, Chrome-trace/JSONL export, cross-module
    propagation via :func:`use_tracer`/:func:`current_tracer`)
  * :mod:`repro_torch.obs.metrics` — process-global counters/gauges (the
    planner's plan-cache hits and misses)
  * :mod:`repro_torch.obs.timing` — THE synchronized timing helper of the
    autotuner's measured refinement

The solver's report and the artifact validation are ROADMAP item A15.
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
    """A span tracer plus the process-global metrics registry;
    ``disable()`` turns the spans into no-ops without touching the
    counters."""

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
