"""Fault tolerance at the training loop's level (counterpart of
``repro.distributed.elastic``): straggler detection, a step timer, and
the mesh to restart on after hosts are lost.

Hosts die (handled by checkpoint and restart, see ``checkpoint.py``) or
straggle: the monitor keeps each host's recent step durations and flags
the hosts whose rolling median exceeds ``threshold`` times the fleet's,
so a scheduler can replace them or the launcher can restart smaller.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["StragglerMonitor", "StepTimer", "ElasticPlan"]


class StragglerMonitor:
    """Tracks per-host step durations, flags hosts whose rolling median
    exceeds ``threshold`` x the fleet median."""

    def __init__(self, num_hosts: int, window: int = 16,
                 threshold: float = 1.5):
        self.num_hosts = num_hosts
        self.window = window
        self.threshold = threshold
        self._hist = [deque(maxlen=window) for _ in range(num_hosts)]

    def record(self, host: int, duration_s: float) -> None:
        self._hist[host].append(duration_s)

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def fleet_median(self) -> Optional[float]:
        per_host = [self._median(h) for h in self._hist if h]
        return self._median(per_host) if per_host else None

    def stragglers(self) -> list[int]:
        fleet = self.fleet_median()
        if fleet is None or fleet <= 0:
            return []
        return [i for i, h in enumerate(self._hist)
                if h and self._median(h) > self.threshold * fleet]

    def healthy_hosts(self) -> int:
        return self.num_hosts - len(self.stragglers())


class StepTimer:
    """Context-manager step timer feeding the monitor. ``sync`` (e.g. a
    device synchronize) runs before the clock stops, so an asynchronous
    device's work counts in the step."""

    def __init__(self, monitor: StragglerMonitor, host: int = 0,
                 sync: Optional[Callable[[], None]] = None):
        self.monitor = monitor
        self.host = host
        self.sync = sync
        self.last: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and exc[0] is None:
            self.sync()
        self.last = time.perf_counter() - self._t0
        self.monitor.record(self.host, self.last)
        return False


@dataclasses.dataclass
class ElasticPlan:
    """The mesh to restart on, given the surviving hosts: data-parallel
    ranks come in pod-sized groups; the model axis stays whole and the
    data-parallel axes shrink to the largest power of two of surviving
    pods (the restore re-places the parameters on the new mesh)."""

    total_hosts: int
    hosts_per_pod: int

    def plan(self, surviving_hosts: int) -> dict:
        pods = max(surviving_hosts // self.hosts_per_pod, 1)
        p2 = 1  # the largest power of two <= pods
        while p2 * 2 <= pods:
            p2 *= 2
        return {
            "pods": p2,
            "dropped_hosts": self.total_hosts - p2 * self.hosts_per_pod,
            "global_batch_scale": p2 * self.hosts_per_pod / self.total_hosts,
        }
