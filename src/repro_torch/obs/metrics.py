"""Process-global metrics registry: counters and gauges with labels (a
copy of the framework-free ``repro.obs.metrics``).

The planner counts its plan-cache hits and misses here (per stage and per
graph key), the solver its PCPG solves, iterations and defect-correction
outers, PCPG its tolerance clamps, and the solver gauges the device bytes
by stack and dtype, by stage and in total. One process-global default registry
(like Prometheus' default registry) keeps the call sites one-liners:

    from repro_torch.obs import metrics
    metrics.inc("plan_cache.stage.miss", stage="dual", dtype="f64")
    metrics.gauge("device_bytes", 123456, stack="L", dtype="f32")

Labels are flattened into the metric key (``name{k=v,...}`` with sorted
label keys), so :func:`snapshot` returns plain JSON-safe dicts. Tests
(and anything wanting hermetic counts) call :func:`reset` first.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "Registry",
    "REGISTRY",
    "inc",
    "gauge",
    "get",
    "get_matching",
    "snapshot",
    "reset",
]


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Thread-safe counters (monotonic) and gauges (last value wins)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    def inc(self, name: str, value: float = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def get(self, name: str, **labels) -> float:
        """Current counter value (0 when never incremented)."""
        k = _key(name, labels)
        with self._lock:
            return self._counters.get(k, self._gauges.get(k, 0))

    def get_matching(self, prefix: str) -> dict:
        """All counters whose key starts with ``prefix`` (labels ignored)."""
        with self._lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


REGISTRY = Registry()


def inc(name: str, value: float = 1, *,
        registry: Optional[Registry] = None, **labels) -> None:
    (registry or REGISTRY).inc(name, value, **labels)


def gauge(name: str, value: float, *,
          registry: Optional[Registry] = None, **labels) -> None:
    (registry or REGISTRY).gauge(name, value, **labels)


def get(name: str, *, registry: Optional[Registry] = None, **labels) -> float:
    return (registry or REGISTRY).get(name, **labels)


def get_matching(prefix: str, *,
                 registry: Optional[Registry] = None) -> dict:
    return (registry or REGISTRY).get_matching(prefix)


def snapshot(registry: Optional[Registry] = None) -> dict:
    return (registry or REGISTRY).snapshot()


def reset(registry: Optional[Registry] = None) -> None:
    (registry or REGISTRY).reset()
