"""Nested span tracer (counterpart of ``repro.obs.trace``).

A :class:`Tracer` records a flat list of :class:`Span` records with
parent/depth links — the context-manager API keeps nesting implicit:

    tr = Tracer()
    with tr.span("solve"):
        with tr.span("pcpg", tol=1e-9) as sp:
            res = run(d, lam0)
            sp.sync(res.lam)          # device sync at span close
            sp.set(iterations=int(res.iterations))

CUDA launches are asynchronous, so a span that launches device work but
does not wait for it measures the enqueue, not the work. ``sp.sync(x,
...)`` registers tensors (or containers of them) whose CUDA devices are
synchronized at span close (:func:`repro_torch.obs.timing.synchronize`),
so the recorded end time covers the device work the span claims.

Disabled tracers (``Tracer(enabled=False)``) hand out a shared no-op span
— no allocation, no clock reads, no sync — so instrumented code paths cost
nothing when telemetry is off.

Spans export as JSONL (one span per line, ``schema_version`` on every
record) and as the Chrome trace event format readable by
``chrome://tracing`` / Perfetto (:meth:`Tracer.to_chrome_trace`).

Cross-module propagation uses a tracer stack: a caller installs its tracer
with :func:`use_tracer` and downstream layers (the stage graph, the
autotuner) pick it up via :func:`current_tracer` — no tracer installed
means every downstream span is a no-op.

:func:`annotation` wraps a host region in
``torch.profiler.record_function`` so profiler traces line up with the
span names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Optional

from repro_torch.obs.timing import synchronize

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "Span",
    "Tracer",
    "current_tracer",
    "use_tracer",
    "annotation",
]

TRACE_SCHEMA_VERSION = 1


@dataclasses.dataclass
class Span:
    """One closed (or still-open) region of the timeline."""

    name: str
    t_start: float  # perf_counter seconds (absolute)
    t_end: Optional[float] = None
    depth: int = 0
    parent: Optional[int] = None  # index into Tracer.spans
    index: int = -1
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        """Seconds between open and close (0.0 while still open)."""
        return 0.0 if self.t_end is None else self.t_end - self.t_start


class _NullSpan:
    """The disabled path: a shared do-nothing span/context manager."""

    __slots__ = ()
    duration = 0.0
    attrs: dict = {}

    def sync(self, *values):
        return self

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanHandle:
    """Context manager for one open span on one tracer."""

    __slots__ = ("_tracer", "span", "_sync")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._sync: list = []

    def sync(self, *values):
        """Register tensors (or containers of them) to synchronize at
        close."""
        self._sync.extend(v for v in values if v is not None)
        return self

    def set(self, **attrs):
        self.span.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        return self.span.duration

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._sync:
            synchronize(*self._sync)
        self._tracer._close(self.span)
        return False


class Tracer:
    """Collects nested spans; near-zero overhead when ``enabled=False``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a nested span; use as a context manager."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(
            name=name,
            t_start=time.perf_counter(),
            depth=len(self._stack),
            parent=self._stack[-1] if self._stack else None,
            index=len(self.spans),
            attrs=attrs,
        )
        self.spans.append(sp)
        self._stack.append(sp.index)
        return _SpanHandle(self, sp)

    def _close(self, span: Span) -> None:
        span.t_end = time.perf_counter()
        if self._stack and self._stack[-1] == span.index:
            self._stack.pop()
        elif span.index in self._stack:  # defensive: out-of-order close
            self._stack.remove(span.index)

    def clear(self) -> None:
        self.spans = []
        self._stack = []
        self._epoch = time.perf_counter()

    # -- queries -----------------------------------------------------------

    def last(self, name: str) -> Optional[Span]:
        """Most recent CLOSED span with this name, or None."""
        for sp in reversed(self.spans):
            if sp.name == name and sp.t_end is not None:
                return sp
        return None

    def last_duration(self, name: str) -> Optional[float]:
        sp = self.last(name)
        return None if sp is None else sp.duration

    def tree(self) -> list:
        """Nested view: list of root span dicts with ``children`` lists."""
        nodes = [
            {
                "name": sp.name,
                "t_start_s": sp.t_start - self._epoch,
                "duration_s": sp.duration,
                "attrs": dict(sp.attrs),
                "children": [],
            }
            for sp in self.spans
        ]
        roots: list = []
        for sp, node in zip(self.spans, nodes):
            if sp.parent is None:
                roots.append(node)
            else:
                nodes[sp.parent]["children"].append(node)
        return roots

    # -- export ------------------------------------------------------------

    def _records(self) -> list:
        return [
            {
                "schema_version": TRACE_SCHEMA_VERSION,
                "name": sp.name,
                "ts_us": (sp.t_start - self._epoch) * 1e6,
                "dur_us": sp.duration * 1e6,
                "depth": sp.depth,
                "parent": sp.parent,
                "attrs": _jsonable(sp.attrs),
            }
            for sp in self.spans
        ]

    def to_jsonl(self, path: str) -> None:
        """One span per line; every record carries ``schema_version``."""
        with open(path, "w") as f:
            for rec in self._records():
                f.write(json.dumps(rec) + "\n")

    def chrome_trace(self, metrics: Optional[dict] = None) -> dict:
        """The Chrome trace event object (see to_chrome_trace)."""
        events = [
            {
                "name": rec["name"],
                "ph": "X",  # complete event: ts + dur
                "ts": rec["ts_us"],
                "dur": rec["dur_us"],
                "pid": 1,
                "tid": 1,
                "args": rec["attrs"],
            }
            for rec in self._records()
        ]
        return {
            "schema_version": TRACE_SCHEMA_VERSION,
            "displayTimeUnit": "ms",
            "traceEvents": events,
            "metrics": _jsonable(metrics or {}),
        }

    def to_chrome_trace(self, path: str,
                        metrics: Optional[dict] = None) -> None:
        """Write a ``chrome://tracing`` / Perfetto-loadable JSON file.

        ``metrics`` (e.g. a :func:`repro_torch.obs.metrics.snapshot`) is
        embedded under the top-level ``metrics`` key so one artifact
        carries the timeline AND the counters (plan-cache hits, ...).
        """
        with open(path, "w") as f:
            json.dump(self.chrome_trace(metrics), f, indent=1)


def _jsonable(obj: Any):
    """Best-effort conversion of span attrs to JSON-safe values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()  # numpy / torch scalars
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


# -- cross-module tracer propagation ---------------------------------------

_DISABLED = Tracer(enabled=False)
_ACTIVE: list[Tracer] = []


def current_tracer() -> Tracer:
    """The innermost tracer installed by :func:`use_tracer` (a disabled
    tracer when none is installed — downstream spans become no-ops)."""
    return _ACTIVE[-1] if _ACTIVE else _DISABLED


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Install ``tracer`` as the current tracer for the dynamic extent."""
    _ACTIVE.append(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.pop()


def annotation(name: str):
    """``torch.profiler.record_function`` for a host region, so profiler
    traces line up with the span names."""
    import torch

    return torch.profiler.record_function(name)
