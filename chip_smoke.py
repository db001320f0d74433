#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

  1. device   — require CUDA; print the card's name and
                ``nvidia-smi --query-gpu=name,power.limit``.
  2. build    — compile every kernel from ``src/repro_torch/kernels/csrc``
                with nvcc (all sources at once), print the build seconds
                and each kernel's ptxas registers, spills and static shared
                memory (marked cached when no build ran), and fail unless the SASS of the stepped SYRK and of
                the fused kernels (``cuobjdump -sass``) holds DMMA, the FP64
                tensor-core instruction.
  3. kernels  — on a real full-size feti-heat-2d factor (S=64, n=4225 ->
                n_pad=4352, m=258 -> m_pad=384, bs=bm=128, f64) and its
                packed form in the fill-mask layout, each of the five
                kernels against its plain torch version (max relative
                difference <= 1e-11), against its unfused or dense twin
                (the packed TRSM against the dense one; a fused kernel
                against TRSM then SYRK; <= 1e-11) and against the library
                calls of kernels/ref.py (one full triangular solve on the
                unpacked factor, one batched product; <= 1e-9). Each is
                timed with CUDA events (median) beside its plain version,
                its library call(s) and the card's bound, with its useful
                TFLOP/s and share of the bound; each fused kernel also
                beside its unfused pair run back to back (B1 then B2, B3
                then B2).
  4. main     — ``repro_torch.launch.solve_feti.main`` at full size, four
                times: ``--kernels``, ``--storage packed --kernels``,
                ``--fused`` and ``--storage packed --fused``, each with
                ``--validate``. Each must exit 0 (converged, within 1e-6 of
                the global sparse solve), launch every kernel of its path
                and take a PCPG iteration count within one of the dense
                run's; the packed ``--kernels`` run's peak device memory
                must be at most half of the dense run's.

Then one JSON line with the kernels' numbers and, last, the device line.
The port imports no JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import gc
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
REL_TOL = 1e-11  # kernel vs plain version or twin, f64: sums in another order
LIB_TOL = 1e-9  # kernel vs the library call: another algorithm (full TRSM)
# NVIDIA H100 SXM data sheet, dense: FP64 through the tensor cores (DMMA);
# plain FP64 FMA peaks at half of it. Both assume the 700 W power limit.
PEAK_FP64_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
REPS = 5

# (name, launcher flags, the kernels its path must launch)
MAIN_RUNS = (
    ("dense --kernels", ["--kernels"], ("stepped_trsm", "stepped_syrk")),
    ("packed --kernels", ["--storage", "packed", "--kernels"],
     ("stepped_trsm_packed", "stepped_syrk")),
    ("dense --fused", ["--fused"], ("stepped_trsm_syrk",)),
    ("packed --fused", ["--storage", "packed", "--fused"],
     ("stepped_trsm_syrk_packed",)),
)
# the main-path run whose launch count each kernel reports
LAUNCHES_FROM = {"stepped_trsm": "dense --kernels",
                 "stepped_syrk": "dense --kernels",
                 "stepped_trsm_packed": "packed --kernels",
                 "stepped_trsm_syrk": "dense --fused",
                 "stepped_trsm_syrk_packed": "packed --fused"}
F_KERNELS = ("stepped_syrk", "stepped_trsm_syrk", "stepped_trsm_syrk_packed")
# (library, a substring of the mangled kernel name) of each kernel
INSTANCES = {
    "stepped_trsm": ("stepped_trsm", "DenseFactor"),
    "stepped_trsm_packed": ("stepped_trsm", "PackedFactor"),
    "stepped_syrk": ("stepped_syrk", "stepped_syrk_kernel"),
    "stepped_trsm_syrk": ("stepped_trsm_syrk", "DenseFactor"),
    "stepped_trsm_syrk_packed": ("stepped_trsm_syrk", "PackedFactor"),
}
# the libraries whose SASS must run on the FP64 tensor cores
DMMA_LIBS = ("stepped_syrk", "stepped_trsm_syrk")
SOURCES = {
    "stepped_trsm": ("src/repro_torch/kernels/csrc/stepped_trsm.cu",
                     "src/repro/kernels/stepped_trsm.py:66"),
    "stepped_syrk": ("src/repro_torch/kernels/csrc/stepped_syrk.cu",
                     "src/repro/kernels/stepped_syrk.py:60"),
    "stepped_trsm_packed": ("src/repro_torch/kernels/csrc/stepped_trsm.cu",
                            "src/repro/kernels/stepped_trsm.py:136"),
    "stepped_trsm_syrk": ("src/repro_torch/kernels/csrc/stepped_trsm_syrk.cu",
                          "src/repro/kernels/stepped_trsm_syrk.py:145"),
    "stepped_trsm_syrk_packed": (
        "src/repro_torch/kernels/csrc/stepped_trsm_syrk.cu",
        "src/repro/kernels/stepped_trsm_syrk.py:186"),
}


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
    """The stepped operands the main paths build, from a real full-size
    factorization (implicit mode: no assembly, no kernel), and the same
    factor packed in the fill-mask layout."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, preprocess_cluster
    from repro_torch.kernels import ops
    from repro_torch.sparse import pack_factor

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
    packed = pack_factor(st.L, st.index)
    Bpp = torch.gather(st.Btp, 2, st.col_perm[:, None, :].expand_as(st.Btp))
    Lp = ops.pad_factor(st.L, n_pad)
    del st
    Bp = ops._pad_to(Bpp, n_pad, m_pad)
    del Bpp
    starts_np = ops._start_blocks(env, bm, bs, m_pad, n_pad)
    starts = torch.as_tensor(starts_np, device=device)
    # the fused kernels' item lists, as ops.stepped_trsm_syrk builds them
    orders = (ops._fused_order(env, S, device),
              ops._fused_order(env, S, device, packed.index))
    torch.cuda.synchronize()
    return dict(S=S, env=env, bs=bs, bm=bm, n_pad=n_pad, m_pad=m_pad,
                Lp=Lp, Bp=Bp, Linv=ops.invert_diag_blocks(Lp, bs),
                packed=packed, packed_ops=ops._packed_operands(packed, env),
                starts=starts, starts_np=starts_np, orders=orders)


def _packed_walk(x):
    """FLOPs and factor bytes of the packed TRSM's walk on this run's
    data: per stripe, rows k >= start, the stored off-diagonal slots with
    block column >= start (2 r_k r_j w each) and the diagonal triangular
    solve (r_k^2 w); w is the stripe's real column count, r_k a block's
    real row count. The factor bytes count every slot some stripe walks,
    once."""
    env, index = x["env"], x["packed"].index
    bs, n = x["bs"], env.n
    rows = [min(bs, n - k * bs) for k in range(index.nb)]
    flops = 0
    walked = set()
    for c, start in enumerate(int(s) for s in x["starts_np"]):
        c0, c1 = env.col_block(c) if c < env.num_col_blocks else (0, 0)
        w = c1 - c0
        for k in range(start, index.nb):
            flops += rows[k] * rows[k] * w
            for j, t in index.row_slots(k):
                if j >= start:
                    flops += 2 * rows[k] * rows[j] * w
                    walked.add(t)
    return x["S"] * flops, 8 * x["S"] * len(walked) * bs * bs


def ptxas_report(build, built):
    """{kernel: {registers, spill_stores, spill_loads, static_smem,
    ptxas_cached}} from the nvcc logs (``-Xptxas -v``); ``ptxas_cached``
    when the library was not in ``built``, the builds of this run, so its
    log is an earlier build's."""
    per_lib = {}
    for lib in {lib for lib, _ in INSTANCES.values()}:
        log = build._library_path(lib).with_suffix(".log")
        per_lib[lib] = re.split(r"Compiling entry function",
                                log.read_text())[1:]
    out = {}
    for name, (lib, tag) in INSTANCES.items():
        block = next(b for b in per_lib[lib] if tag in b.split("'")[1])
        regs = re.search(r"Used (\d+) registers", block)
        # one line per function: the kernel and any function it calls
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out[name] = dict(registers=int(regs.group(1)),
                         spill_stores=sum(int(a) for a, _ in spills),
                         spill_loads=sum(int(b) for _, b in spills),
                         static_smem=int(smem.group(1)) if smem else 0,
                         ptxas_cached=lib not in built)
    return out


def dmma_counts(build):
    """DMMA instructions in the SASS of each library of DMMA_LIBS."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    counts = {}
    for lib in DMMA_LIBS:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(build._library_path(lib))],
            capture_output=True, text=True, check=True, timeout=120).stdout
        counts[lib] = len(re.findall(r"\bDMMA\b", sass))
    return counts


def bounds(x):
    """Least card time (ms) of each kernel's work on this run's inputs: the
    larger of its f64 operations over the FP64 peak and the bytes it must
    move (each input read once, each output written once) over the memory
    rate. Operations come from the repo's FLOP model of the schedule, or,
    for the packed TRSM, from the stored slots it walks. A fused kernel
    need not move Y: its bytes are factor + Linv + B + F."""
    S, bs, bm, n_pad, m_pad = x["S"], x["bs"], x["bm"], x["n_pad"], x["m_pad"]
    env, starts = x["env"], [int(s) for s in x["starts_np"]]
    nb = n_pad // bs
    rows_from = nb - min(starts)
    dense_L = 8 * S * bs * bs * rows_from * (rows_from + 1) // 2
    linv = 8 * S * bs * bs * rows_from
    B = 8 * S * sum((nb - s) * bs * bm for s in starts)
    Y = 8 * S * n_pad * m_pad
    F = 8 * S * m_pad * m_pad
    trsm = S * env.flops_trsm_rhs_split()
    syrk = S * env.flops_syrk_output_split()
    packed_flops, packed_L = _packed_walk(x)
    work = {
        "stepped_trsm": (trsm, dense_L + linv + B + Y),
        "stepped_syrk": (syrk, B + F),  # Y below each start, read once
        "stepped_trsm_packed": (packed_flops, packed_L + linv + B + Y),
        "stepped_trsm_syrk": (trsm + syrk, dense_L + linv + B + F),
        "stepped_trsm_syrk_packed": (packed_flops + syrk,
                                     packed_L + linv + B + F),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FP64_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = dict(flops=flops, bytes=nbytes,
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
    return out


def upper_tiles_zero(F, bm, m_pad):
    return all(bool((F[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0).all())
               for i in range(m_pad // bm))


def check_kernels(x, ptxas):
    """Hold each kernel against its plain version, its twin and the library
    call(s), then time it. Returns the JSON rows (without launches)."""
    import torch

    from repro_torch.kernels import (
        ops,
        stepped_syrk_kernel,
        stepped_syrk_plain,
        stepped_trsm_kernel,
        stepped_trsm_packed_kernel,
        stepped_trsm_packed_plain,
        stepped_trsm_plain,
        stepped_trsm_syrk_kernel,
        stepped_trsm_syrk_packed_kernel,
        stepped_trsm_syrk_packed_plain,
        stepped_trsm_syrk_plain,
    )
    from repro_torch.kernels.ref import syrk_ref, trsm_ref

    bs, bm, n_pad, m_pad = x["bs"], x["bm"], x["n_pad"], x["m_pad"]
    Bp, starts = x["Bp"], x["starts"]
    dense = (x["Linv"], x["Lp"])
    packed = x["packed_ops"]
    order, packed_order = x["orders"]
    index = x["packed"].index
    print(f"[chip_smoke] shapes: S={x['S']} n_pad={n_pad} m_pad={m_pad} "
          f"bs={bs} bm={bm} start_block={x['starts_np'].tolist()} packed "
          f"blocks={index.n_blocks}/{index.nb * (index.nb + 1) // 2}",
          flush=True)
    bnd = bounds(x)
    # the library yardsticks: one full triangular solve on the dense factor
    # and on the unpacked packed one, one batched product
    Lu = ops.pad_factor(x["packed"].unpack(), n_pad)
    lib = {
        "stepped_trsm": lambda: trsm_ref(x["Lp"], Bp),
        "stepped_syrk": None,  # set once Y exists: syrk_ref(Y)
        "stepped_trsm_packed": lambda: trsm_ref(Lu, Bp),
        "stepped_trsm_syrk": lambda: syrk_ref(trsm_ref(x["Lp"], Bp)),
        "stepped_trsm_syrk_packed": lambda: syrk_ref(trsm_ref(Lu, Bp)),
    }
    lib_names = {
        "stepped_trsm": "torch.linalg.solve_triangular (full padded)",
        "stepped_syrk": "bmm-based Y^T Y",
        "stepped_trsm_packed": "torch.linalg.solve_triangular on the "
                               "unpacked factor",
        "stepped_trsm_syrk": "solve_triangular then Y^T Y",
        "stepped_trsm_syrk_packed": "solve_triangular on the unpacked "
                                    "factor then Y^T Y",
    }
    Y = stepped_trsm_kernel(*dense, Bp, starts, bs, bm)
    torch.cuda.synchronize()
    lib["stepped_syrk"] = lambda: syrk_ref(Y)
    kernels = {
        "stepped_trsm": (lambda: stepped_trsm_kernel(*dense, Bp, starts, bs, bm),
                         lambda: stepped_trsm_plain(*dense, Bp, starts, bs, bm),
                         None),
        "stepped_syrk": (lambda: stepped_syrk_kernel(Y, starts, bs, bm),
                         lambda: stepped_syrk_plain(Y, starts, bs, bm), None),
        "stepped_trsm_packed": (
            lambda: stepped_trsm_packed_kernel(*packed, Bp, starts, bs, bm),
            lambda: stepped_trsm_packed_plain(*packed, Bp, starts, bs, bm),
            lambda: Y),
        "stepped_trsm_syrk": (
            lambda: stepped_trsm_syrk_kernel(*dense, Bp, starts, bs, bm,
                                             order=order),
            lambda: stepped_trsm_syrk_plain(*dense, Bp, starts, bs, bm),
            lambda: stepped_syrk_kernel(Y, starts, bs, bm)),
        "stepped_trsm_syrk_packed": (
            lambda: stepped_trsm_syrk_packed_kernel(*packed, Bp, starts, bs,
                                                    bm, order=packed_order),
            lambda: stepped_trsm_syrk_packed_plain(*packed, Bp, starts, bs, bm),
            lambda: stepped_syrk_kernel(
                stepped_trsm_packed_kernel(*packed, Bp, starts, bs, bm),
                starts, bs, bm)),
    }
    # the fused kernels' yardstick: their unfused pair, back to back
    pairs = {
        "stepped_trsm_syrk": lambda: stepped_syrk_kernel(
            stepped_trsm_kernel(*dense, Bp, starts, bs, bm), starts, bs, bm),
        "stepped_trsm_syrk_packed": lambda: stepped_syrk_kernel(
            stepped_trsm_packed_kernel(*packed, Bp, starts, bs, bm), starts,
            bs, bm),
    }
    rows = []
    for name, (kernel, plain, twin) in kernels.items():
        got = kernel()
        torch.cuda.synchronize()
        abs_err, rel_err = compare(got, plain())
        twin_err = compare(got, twin())[1] if twin is not None else 0.0
        is_F = name in F_KERNELS
        full = ops._mirror_lower(got, bm, m_pad, m_pad) if is_F else got
        lib_err = compare(full, lib[name]())[1]
        zero_ok = upper_tiles_zero(got, bm, m_pad) if is_F else True
        print(f"[chip_smoke] {name}: max|out|={got.abs().max().item():.3e} "
              f"max|kernel-plain|={abs_err:.3e} rel={rel_err:.3e} rel vs "
              f"twin={twin_err:.3e} rel vs library={lib_err:.3e}"
              + (f" upper tiles zero={zero_ok}" if is_F else ""), flush=True)
        if not (rel_err <= REL_TOL and twin_err <= REL_TOL
                and lib_err <= LIB_TOL and zero_ok
                and bool(torch.isfinite(got).all())):
            raise SystemExit(f"{name} disagrees: rel {rel_err:.3e} to its "
                             f"plain version, {twin_err:.3e} to its twin, "
                             f"{lib_err:.3e} to the library, upper tiles "
                             f"zero={zero_ok}")
        del got, full
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(lib[name])
        pair_ms = cuda_ms(pairs[name]) if name in pairs else None
        source, replaces = SOURCES[name]
        b = bnd[name]
        tflops = b["flops"] / ms / 1e9
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=abs_err, max_rel_err=rel_err, twin_rel_err=twin_err,
            library_rel_err=lib_err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_call=lib_names[name],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], tflops=tflops,
            bound_share=b["bound_ms"] / ms, unfused_pair_ms=pair_ms,
            **ptxas[name]))
        print(f"[chip_smoke] {name}: {ms:.3f} ms (plain {plain_ms:.3f}, "
              f"library {library_ms:.3f}, bound {b['bound_ms']:.3f} by "
              f"{b['bound_by']}: {b['flops']:.4e} f64 flop at "
              f"{PEAK_FP64_FLOPS / 1e12:g} TFLOP/s, {b['bytes']:.4e} B at "
              f"{PEAK_BYTES_PER_S / 1e12:g} TB/s)", flush=True)
        print(f"[chip_smoke] {name}: {tflops:.2f} useful TFLOP/s, "
              f"{100 * b['bound_ms'] / ms:.1f}% of the bound, "
              f"{library_ms / ms:.2f}x the library call's speed"
              + (f"; unfused pair back to back {pair_ms:.3f} ms "
                 f"({pair_ms / ms:.2f}x the fused time)"
                 if pair_ms is not None else ""), flush=True)
    return rows


def _counters():
    from repro_torch import kernels

    return {name: getattr(kernels, f"{name}_kernel") for name in SOURCES}


def run_main_path(name, flags, path_kernels):
    """Drive the launcher at full size; returns this run's launch counts,
    iteration count and peak device memory."""
    import torch

    from repro_torch.launch import solve_feti

    argv = ["--arch", ARCH, *flags, "--validate"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = solve_feti.main(argv)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise SystemExit(f"solve_feti {' '.join(argv)} exited {rc}")
    m_iters = re.search(r"iters=(\d+) residual=(\S+) converged=(\w+)", out)
    m_err = re.search(r"rel err vs global solve: (\S+)", out)
    m_time = re.search(r"preprocess=(\S+)s solve=(\S+)s", out)
    if not (m_iters and m_err and m_time) or m_iters.group(3) != "True":
        raise SystemExit(f"{name}: solve_feti did not report a converged, "
                         f"validated solve")
    err = float(m_err.group(1))
    if not err <= 1e-6:
        raise SystemExit(f"{name}: relative error {err:.3e} > 1e-6")
    missing = [k for k in path_kernels if launches[k] < 1]
    if missing:
        raise SystemExit(f"{name}: the path did not launch {missing}: "
                         f"{launches}")
    print(f"[chip_smoke] main path {name}: iterations={m_iters.group(1)} "
          f"rel_err={err:.3e} preprocess_s={m_time.group(1)} "
          f"solve_s={m_time.group(2)} peak_device_bytes={peak:,} "
          f"launches={ {k: launches[k] for k in path_kernels} }", flush=True)
    return dict(launches=launches, iterations=int(m_iters.group(1)),
                peak=peak)


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
    ptxas = ptxas_report(build, secs)
    for name, r in ptxas.items():
        print(f"[chip_smoke] ptxas {name}: {r['registers']} registers, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
              f"spill loads, {r['static_smem']} B static shared memory"
              + (" (cached: an earlier build's log)" if r["ptxas_cached"]
                 else ""), flush=True)
    dmma = dmma_counts(build)
    print(f"[chip_smoke] DMMA instructions in the SASS: {dmma}", flush=True)
    if not all(dmma.values()):
        raise SystemExit(f"no DMMA in the SASS of {dmma}")
    done("build", t0)

    t0 = phase("kernels")
    x = kernel_inputs(device)
    rows = check_kernels(x, ptxas)
    del x
    gc.collect()
    torch.cuda.empty_cache()
    done("kernels", t0)

    t0 = phase("main")
    runs = {}
    for name, flags, path_kernels in MAIN_RUNS:
        runs[name] = run_main_path(name, flags, path_kernels)
    base = runs["dense --kernels"]
    for name, r in runs.items():
        if abs(r["iterations"] - base["iterations"]) > 1:
            raise SystemExit(f"{name}: {r['iterations']} iterations, the "
                             f"dense run took {base['iterations']}")
    ratio = runs["packed --kernels"]["peak"] / base["peak"]
    print(f"[chip_smoke] peak device memory, packed / dense --kernels: "
          f"{runs['packed --kernels']['peak']:,} / {base['peak']:,} = "
          f"{ratio:.3f}", flush=True)
    if ratio > 0.5:
        raise SystemExit("the packed run's peak device memory is above half "
                         "of the dense run's")
    done("main", t0)

    for r in rows:
        r["launches"] = runs[LAUNCHES_FROM[r["name"]]]["launches"][r["name"]]
    print(f"[chip_smoke] total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
