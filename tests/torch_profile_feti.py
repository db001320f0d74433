"""Where an explicit FETI preprocess and its PCPG spend the card's time: one
``torch.profiler`` reading of the port's ``--kernels`` path.

    PYTHONPATH=src python tests/torch_profile_feti.py [--arch feti-heat-2d]
        [--smoke] [--device cpu] [--out FILE.json]

Builds the architecture's problem and its hand-picked config through the
kernels (the launcher's ``--kernels``: dense storage, lumped
preconditioner, f64), preprocesses and solves once untimed (kernel builds,
library handles, clocks), then under ``torch.profiler`` (CPU and CUDA
activities):

* a second ``FetiSolver.preprocess``, its time split by what ran it: the
  symbolic phase (``make_cluster_preprocessor``, the ``init`` span), the
  stiffness upload (``_device_stiffness``: each K_i to the device,
  permuted, regularized and packed; no span holds it), the block Cholesky
  (``block_cholesky``), and inside the dual assembly the factor and
  right-hand-side padding (``pad_factor``, ``_pad_to``), the diagonal
  blocks' inversion (``invert_diag_blocks``), the hand-written kernels
  (their wrappers in ``kernels/ops``) and the mirror of the lower
  triangle; each region's host seconds and its device time (the union of
  the intervals of the kernels and copies that start inside it), beside
  the telemetry spans of the same preprocess and its ten longest device
  operations;
* one PCPG run (``pcpg``, as ``FetiSolver.solve`` calls it), its device
  busy time (the union of its kernels' intervals) over its wall time,
  whose complement is the device's idle share, and its ten longest
  device operations by total time.

Each region is a ``record_function`` this script opens around the
function it replaces for the reading; the program itself is unchanged.
Prints the card's name and power limit, each number, and writes them as
JSON to ``--out`` (default ``build/profile/feti_profile.json``). On the
CPU (``--device cpu``) there is no device time: the script then says so
and reports host times only.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

# (module, function, region) of each region: the symbolic phase, the
# stiffness upload, the factorization, the dual assembly and inside it the
# padding, the inversion, the kernels and the mirror; then PCPG
REGIONS = (
    ("repro_torch.feti.assembly", "make_cluster_preprocessor", "symbolic"),
    ("repro_torch.feti.assembly", "_device_stiffness", "K upload"),
    ("repro_torch.feti.assembly", "block_cholesky", "factorization"),
    ("repro_torch.feti.assembly", "batched_assemble", "assembly"),
    ("repro_torch.kernels.ops", "pad_factor", "assembly: pad_factor"),
    ("repro_torch.kernels.ops", "_pad_to", "assembly: _pad_to"),
    ("repro_torch.kernels.ops", "invert_diag_blocks",
     "assembly: invert_diag_blocks"),
    ("repro_torch.kernels.ops", "stepped_trsm_kernel", "assembly: B1 kernel"),
    ("repro_torch.kernels.ops", "stepped_syrk_kernel", "assembly: B2 kernel"),
    ("repro_torch.kernels.ops", "_mirror_lower", "assembly: mirror"),
    ("repro_torch.feti.solver", "pcpg", "pcpg"),
)


@contextlib.contextmanager
def regions():
    """Every REGIONS function wrapped in a ``record_function`` named after
    its region; yields {region: [host seconds of each call]}."""
    import importlib

    import torch

    host = {label: [] for _, _, label in REGIONS}
    saved = []

    def wrap(fn, label):
        @functools.wraps(fn)
        def timed(*args, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"region: {label}"):
                out = fn(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            host[label].append(time.perf_counter() - t0)
            return out
        return timed

    for mod_name, fn_name, label in REGIONS:
        mod = importlib.import_module(mod_name)
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, wrap(getattr(mod, fn_name), label))
    try:
        yield host
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def _kernels(prof):
    """The device operations (kernels, copies, sets) of a reading; the
    regions' own annotations, which the profiler also lays on the device
    timeline, are not operations."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("region: ")]


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _inside(kernels, a, b):
    """(start, end) of the device operations that start in [a, b]."""
    return [(k.time_range.start, k.time_range.end) for k in kernels
            if a <= k.time_range.start <= b]


def _regions(prof):
    """The regions' host-side events (the profiler mirrors each on the
    device timeline too; those are left out)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.name.startswith("region: ")
            and e.device_type == DeviceType.CPU]


def _region_device_us(prof, kernels):
    """{region: device microseconds (the union of the intervals of the
    operations that start inside its host range; nested regions count in
    each)}."""
    out = {}
    for e in _regions(prof):
        label = e.name.removeprefix("region: ")
        out[label] = out.get(label, 0.0) + _union_us(
            _inside(kernels, e.time_range.start, e.time_range.end))
    return out


def _top(kernels, n=10):
    """The ``n`` device operations with the most total time: [name,
    calls, seconds]."""
    by = {}
    for k in kernels:
        calls, us = by.get(k.name, (0, 0.0))
        by[k.name] = (calls + 1, us + k.time_range.end - k.time_range.start)
    return [[name[:120], calls, us / 1e6] for name, (calls, us) in
            sorted(by.items(), key=lambda kv: -kv[1][1])[:n]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="feti-heat-2d")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=os.path.join("build", "profile",
                                                 "feti_profile.json"))
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.device import resolve_device
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, FetiSolver

    device = resolve_device(args.device)
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(card, flush=True)
    fc = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid,
                             fc.elems_per_sub)
    config = FetiConfig(schur=SchurAssemblyConfig(
        trsm_variant=fc.trsm_variant, syrk_variant=fc.syrk_variant,
        block_size=fc.block_size, rhs_block_size=fc.rhs_block_size,
        use_kernels=True), device=device)
    solver = FetiSolver(prob, config)
    solver.solve()  # untimed: builds, handles, clocks

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    result = dict(arch=fc.name, device=str(device), card=card)
    with regions() as host:
        solver.telemetry.tracer.clear()
        with profile(activities=activities) as prof:
            solver.preprocess()
        spans = {sp.name: sp.duration
                 for sp in solver.telemetry.tracer.spans}
        kernels = _kernels(prof)
        result["preprocess"] = dict(
            spans_s=spans,
            host_s={k: sum(v) for k, v in host.items() if v},
            device_busy_s=_union_us(
                (k.time_range.start, k.time_range.end)
                for k in kernels) / 1e6 if kernels else None,
            device_s_by_region={
                k: v / 1e6 for k, v in _region_device_us(prof, kernels)
                .items()} if kernels else None,
            top_device_ops=_top(kernels))
        for v in host.values():
            v.clear()
        with profile(activities=activities) as prof:
            sol = solver.solve()
        kernels = _kernels(prof)
        window = next((e for e in _regions(prof)
                       if e.name == "region: pcpg"), None)
        inside = ([] if window is None else
                  _inside(kernels, window.time_range.start,
                          window.time_range.end))
        wall_us = (window.time_range.end - window.time_range.start
                   if window is not None else None)
        busy_us = _union_us(inside) if inside else None
        result["pcpg"] = dict(
            iterations=sol.iterations, host_s=host["pcpg"][0],
            wall_s=None if wall_us is None else wall_us / 1e6,
            device_busy_s=None if busy_us is None else busy_us / 1e6,
            device_idle_share=(None if busy_us is None
                               else 1.0 - busy_us / wall_us),
            kernels_launched=len(inside),
            top_device_ops=_top([k for k in kernels if window is not None
                                 and window.time_range.start
                                 <= k.time_range.start
                                 <= window.time_range.end]))
    if not any(k for k in _kernels(prof)):
        print("[profile] no device time in this reading (CPU run, or the "
              "profiler saw no CUDA kernel): device numbers not measured",
              flush=True)
    for phase_name in ("preprocess", "pcpg"):
        print(f"[profile] {phase_name}: {json.dumps(result[phase_name])}",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[profile] -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
