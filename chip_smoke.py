#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

  1. device   — require CUDA; print the card's name and
                ``nvidia-smi --query-gpu=name,power.limit``.
  2. build    — compile every kernel from ``src/repro_torch/kernels/csrc``
                with nvcc (all sources at once) and print the build seconds.
  3. kernels  — on a real full-size feti-heat-2d factor (S=64, n=4225 ->
                n_pad=4352, m=258 -> m_pad=384, bs=bm=128, f64): each kernel
                against its plain torch version (max relative difference
                <= 1e-11), timed with CUDA events (median) beside the plain
                version, a one-call library yardstick (kernels/ref.py: one
                full triangular solve, one batched product) and the card's
                bound.
  4. main     — ``repro_torch.launch.solve_feti.main(["--arch",
                "feti-heat-2d", "--kernels", "--validate"])`` at full size:
                exit 0 (converged, within 1e-6 of the global sparse solve)
                with both kernels' launch counters > 0.

Then one JSON line with the kernels' numbers and, last, the device line.
The port imports no JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH = "feti-heat-2d"
REL_TOL = 1e-11  # kernel vs plain version, f64: sums in another order
LIB_TOL = 1e-9  # kernel vs the library call: another algorithm (full TRSM)
# NVIDIA H100 SXM data sheet, dense: FP64 through the tensor cores (DMMA);
# plain FP64 FMA peaks at half of it. Both assume the 700 W power limit.
PEAK_FP64_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
REPS = 5


def phase(name):
    print(f"[chip_smoke] --- {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"[chip_smoke] {name}: {time.perf_counter() - t0:.1f}s", flush=True)


def cuda_ms(fn, reps=REPS):
    """Median over ``reps`` runs of ``fn`` (after one warm-up), each timed
    with CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(got, want):
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return diff, diff / max(scale, 1e-300)


def kernel_inputs(device):
    """The stepped TRSM/SYRK operands the main path builds, from a real
    full-size factorization (implicit mode: no assembly, no kernel)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, preprocess_cluster
    from repro_torch.kernels import ops

    fc = get_config(ARCH)
    t0 = time.perf_counter()
    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid, fc.elems_per_sub)
    t1 = time.perf_counter()
    cfg = SchurAssemblyConfig(block_size=fc.block_size,
                              rhs_block_size=fc.rhs_block_size)
    st = preprocess_cluster(prob, FetiConfig(schur=cfg, mode="implicit",
                                             device=device))
    torch.cuda.synchronize()
    print(f"[chip_smoke] host decomposition {t1 - t0:.2f}s; preprocessing "
          f"without assembly (upload, symbolic, factorization) "
          f"{time.perf_counter() - t1:.2f}s", flush=True)
    env = st.env
    bs, bm = env.block_size, env.rhs_block_size
    n_pad, m_pad = -(-env.n // bs) * bs, -(-env.m // bm) * bm
    S = st.S
    Bpp = torch.gather(st.Btp, 2, st.col_perm[:, None, :].expand_as(st.Btp))
    Lp = ops.pad_factor(st.L, n_pad)
    del st
    Bp = ops._pad_to(Bpp, n_pad, m_pad)
    del Bpp
    starts_np = ops._start_blocks(env, bm, bs, m_pad, n_pad)
    starts = torch.as_tensor(starts_np, device=device)
    Linv = ops.invert_diag_blocks(Lp, bs)
    torch.cuda.synchronize()
    return dict(S=S, env=env, bs=bs, bm=bm, n_pad=n_pad, m_pad=m_pad,
                Lp=Lp, Bp=Bp, Linv=Linv, starts=starts, starts_np=starts_np)


def bounds(x):
    """Least card time (ms) of each kernel's work on this run's inputs: the
    larger of its f64 operations over the FP64 peak and the bytes it must
    move (each input read once, each output written once) over the memory
    rate. Operations come from the repo's FLOP model of the schedule."""
    S, bs, bm, n_pad, m_pad = x["S"], x["bs"], x["bm"], x["n_pad"], x["m_pad"]
    env, starts = x["env"], [int(s) for s in x["starts_np"]]
    nb = n_pad // bs
    s0 = min(starts)
    rows_from = nb - s0
    trsm_bytes = 8 * S * (bs * bs * rows_from * (rows_from + 1) // 2  # L
                          + bs * bs * rows_from  # Linv
                          + sum((nb - s) * bs * bm for s in starts)  # B
                          + n_pad * m_pad)  # Y
    syrk_bytes = 8 * S * (sum((nb - s) * bs * bm for s in starts)  # Y
                          + m_pad * m_pad)  # F
    out = {}
    for name, flops, nbytes in (
            ("stepped_trsm", S * env.flops_trsm_rhs_split(), trsm_bytes),
            ("stepped_syrk", S * env.flops_syrk_output_split(), syrk_bytes)):
        t_ops = flops / PEAK_FP64_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = dict(flops=flops, bytes=nbytes,
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
    return out


def check_kernels(x):
    import torch

    from repro_torch.kernels import (
        ops,
        stepped_syrk_kernel,
        stepped_syrk_plain,
        stepped_trsm_kernel,
        stepped_trsm_plain,
    )
    from repro_torch.kernels.ref import syrk_ref, trsm_ref

    bs, bm = x["bs"], x["bm"]
    Linv, Lp, Bp, starts = x["Linv"], x["Lp"], x["Bp"], x["starts"]
    print(f"[chip_smoke] shapes: S={x['S']} n_pad={x['n_pad']} "
          f"m_pad={x['m_pad']} bs={bs} bm={bm} start_block={x['starts_np'].tolist()}",
          flush=True)
    bnd = bounds(x)
    rows = []

    Y = stepped_trsm_kernel(Linv, Lp, Bp, starts, bs, bm)
    torch.cuda.synchronize()
    Y_plain = stepped_trsm_plain(Linv, Lp, Bp, starts, bs, bm)
    abs_err, rel_err = compare(Y, Y_plain)
    _, lib_err = compare(Y, trsm_ref(Lp, Bp))
    print(f"[chip_smoke] stepped_trsm: max|Y|={Y.abs().max().item():.3e} "
          f"nonzeros={int((Y != 0).sum())} max|kernel-plain|={abs_err:.3e} "
          f"rel={rel_err:.3e} rel vs library={lib_err:.3e}", flush=True)
    if not (rel_err <= REL_TOL and lib_err <= LIB_TOL
            and torch.isfinite(Y).all()):
        raise SystemExit(f"stepped_trsm disagrees: rel {rel_err:.3e} to its "
                         f"plain version, {lib_err:.3e} to the library")
    del Y_plain
    ms = cuda_ms(lambda: stepped_trsm_kernel(Linv, Lp, Bp, starts, bs, bm))
    plain_ms = cuda_ms(lambda: stepped_trsm_plain(Linv, Lp, Bp, starts, bs, bm))
    library_ms = cuda_ms(lambda: trsm_ref(Lp, Bp))
    rows.append(dict(
        name="stepped_trsm", route="cuda",
        source="src/repro_torch/kernels/csrc/stepped_trsm.cu",
        replaces="src/repro/kernels/stepped_trsm.py:66",
        tpu_kernel="src/repro/kernels/stepped_trsm.py:stepped_trsm_pallas",
        max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bnd["stepped_trsm"]["bound_ms"],
        bound_by=bnd["stepped_trsm"]["bound_by"]))

    F = stepped_syrk_kernel(Y, starts, bs, bm)
    torch.cuda.synchronize()
    F_plain = stepped_syrk_plain(Y, starts, bs, bm)
    abs_err, rel_err = compare(F, F_plain)
    m_pad = x["m_pad"]
    upper_zero = all(
        bool((F[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0).all())
        for i in range(m_pad // bm))
    _, lib_err = compare(ops._mirror_lower(F, bm, m_pad, m_pad), syrk_ref(Y))
    print(f"[chip_smoke] stepped_syrk: max|F|={F.abs().max().item():.3e} "
          f"max|kernel-plain|={abs_err:.3e} rel={rel_err:.3e} rel vs "
          f"library={lib_err:.3e} upper tiles zero={upper_zero}", flush=True)
    if not (rel_err <= REL_TOL and lib_err <= LIB_TOL and upper_zero
            and torch.isfinite(F).all()):
        raise SystemExit(f"stepped_syrk disagrees: rel {rel_err:.3e} to its "
                         f"plain version, {lib_err:.3e} to the library, or "
                         f"upper tiles nonzero")
    del F_plain
    ms = cuda_ms(lambda: stepped_syrk_kernel(Y, starts, bs, bm))
    plain_ms = cuda_ms(lambda: stepped_syrk_plain(Y, starts, bs, bm))
    library_ms = cuda_ms(lambda: syrk_ref(Y))
    rows.append(dict(
        name="stepped_syrk", route="cuda",
        source="src/repro_torch/kernels/csrc/stepped_syrk.cu",
        replaces="src/repro/kernels/stepped_syrk.py:60",
        tpu_kernel="src/repro/kernels/stepped_syrk.py:stepped_syrk_pallas",
        max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bnd["stepped_syrk"]["bound_ms"],
        bound_by=bnd["stepped_syrk"]["bound_by"]))
    for r in rows:
        b = bnd[r["name"]]
        print(f"[chip_smoke] {r['name']}: {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f}, library {r['library_ms']:.3f}, bound "
              f"{r['bound_ms']:.3f} by {r['bound_by']}: {b['flops']:.4e} f64 "
              f"flop at {PEAK_FP64_FLOPS / 1e12:g} TFLOP/s, {b['bytes']:.4e} B "
              f"at {PEAK_BYTES_PER_S / 1e12:g} TB/s)", flush=True)
    return rows


def run_main_path():
    """Drive the launcher at full size with the kernels; returns the launch
    counts of this run and the launcher's output."""
    from repro_torch.kernels import stepped_syrk_kernel, stepped_trsm_kernel
    from repro_torch.launch import solve_feti

    argv = ["--arch", ARCH, "--kernels", "--validate"]
    stepped_trsm_kernel.launches = 0
    stepped_syrk_kernel.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = solve_feti.main(argv)
    launches = {"stepped_trsm": stepped_trsm_kernel.launches,
                "stepped_syrk": stepped_syrk_kernel.launches}
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise SystemExit(f"solve_feti {' '.join(argv)} exited {rc}")
    m_iters = re.search(r"iters=(\d+) residual=(\S+) converged=(\w+)", out)
    m_err = re.search(r"rel err vs global solve: (\S+)", out)
    m_time = re.search(r"preprocess=(\S+)s solve=(\S+)s", out)
    if not (m_iters and m_err and m_time) or m_iters.group(3) != "True":
        raise SystemExit("solve_feti did not report a converged, validated solve")
    err = float(m_err.group(1))
    if not err <= 1e-6:
        raise SystemExit(f"relative error {err:.3e} > 1e-6")
    if min(launches.values()) < 1:
        raise SystemExit(f"the main path did not launch every kernel: {launches}")
    print(f"[chip_smoke] main path: iterations={m_iters.group(1)} "
          f"rel_err={err:.3e} preprocess_s={m_time.group(1)} "
          f"solve_s={m_time.group(2)} launches={launches}", flush=True)
    return launches


def main() -> int:
    t_all = time.perf_counter()
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch

    t0 = phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    done("device", t0)

    t0 = phase("build")
    from repro_torch.kernels import build

    secs = build.build(build.KERNELS)
    for name in build.KERNELS:
        log = build._library_path(name).with_suffix(".log")
        if log.exists():
            print(f"[chip_smoke] nvcc {name}:\n{log.read_text().strip()}")
    print(f"[chip_smoke] built {sorted(secs)} in "
          f"{max(secs.values(), default=0.0):.1f}s", flush=True)
    done("build", t0)

    t0 = phase("kernels")
    x = kernel_inputs(device)
    rows = check_kernels(x)
    del x
    torch.cuda.empty_cache()
    done("kernels", t0)

    t0 = phase("main")
    launches = run_main_path()
    done("main", t0)

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"[chip_smoke] total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
