"""The ONE synchronized-timing helper (counterpart of ``repro.obs.timing``).

CUDA launches are asynchronous: a wall-clock read after a call measures
its enqueue, not its work, unless the device has finished first. Every
timed micro-run of the port (the autotuner's measured refinement) goes
through this module, so the synchronization discipline lives in one place.
Each rep synchronizes every CUDA device its result lives on before the
clock is read; CPU results are complete when the call returns. Warmup
calls are never timed: a kernel's first call may build it
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

__all__ = ["synchronize", "timed_reps", "min_time", "time_call"]


def _cuda_devices(x: Any, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        # e.g. a PackedBlocks factor: its tensors are fields
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def synchronize(*values: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``values``
    (tensors, containers of them, or dataclasses with tensor fields)."""
    for dev in _cuda_devices(values, set()):
        torch.cuda.synchronize(dev)


def timed_reps(fn: Callable, *args, reps: int = 5,
               warmup: int = 1) -> list:
    """Per-rep synchronized wall times (seconds): ``warmup`` untimed calls,
    then ``reps`` timed ones, each synchronized before the clock is read."""
    for _ in range(warmup):
        synchronize(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def min_time(fn: Callable, *args, reps: int = 5, warmup: int = 2) -> float:
    """Min-of-reps synchronized wall time (seconds): the minimum is the
    standard microbenchmark estimator under one-sided interference noise."""
    return min(timed_reps(fn, *args, reps=reps, warmup=warmup))


def time_call(fn: Callable, *args, reps: int = 5, warmup: int = 1):
    """``(best_seconds, result)``: min-of-reps synchronized timing that
    also hands back the fastest rep's result."""
    for _ in range(warmup):
        synchronize(fn(*args))
    best, best_res = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn(*args)
        synchronize(res)
        t = time.perf_counter() - t0
        if best is None or t < best:
            best, best_res = t, res
    return best, best_res
