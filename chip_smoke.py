#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

  1. device   — require CUDA; print the card's name and
                ``nvidia-smi --query-gpu=name,power.limit``.
  2. build    — compile every kernel from ``src/repro_torch/kernels/csrc``
                with nvcc (all sources at once), print the build seconds
                and each kernel's ptxas registers, spills and static shared
                memory (marked cached when no build ran), and fail unless
                the SASS of the stepped SYRK and of the fused kernels
                (``cuobjdump -sass``) holds DMMA, the FP64 tensor-core
                instruction.
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
  4. dirichlet — the same five checks and timings on the Dirichlet stage's
                operands of the full-size feti-heat-3d configuration (S=64
                subdomains of 16^3 elements: the interior factor, n_i=3375
                -> 3456, dense and packed in the interior fill-mask layout;
                the right-hand side K_ib, n_b=1538 -> 1664 columns in
                stepped order, padded columns exact zeros), and S_b =
                K_bb - K_bi K_ii^-1 K_ib from the stage's assembler through
                the kernels (unfused and fused) against the plain variants
                (<= 1e-11).
  5. main     — ``repro_torch.launch.solve_feti.main``, each run with
                ``--validate``: feti-heat-2d at full size four times
                (``--kernels``, ``--storage packed --kernels``, ``--fused``,
                ``--storage packed --fused``), then six Dirichlet and
                elasticity runs: feti-elasticity-2d ``--kernels --precond
                dirichlet`` and ``--storage packed --fused --precond
                dirichlet``, feti-elasticity-3d ``--storage packed --kernels
                --precond dirichlet``, ``--fused --precond dirichlet`` and
                ``--kernels`` (lumped), and feti-heat-3d ``--kernels
                --precond dirichlet`` at a cut depth (HEAT3D_SUB_GRID,
                registered as the architecture HEAT3D_CUT: the scipy oracle
                of --validate decides the depth). Each must exit 0
                (converged, within 1e-6 of the global sparse solve) and
                launch exactly the kernels its path runs, as often as it
                runs them: once per kernel and stage, so twice on a
                Dirichlet path. Every launch is held, right after it
                returns, against the kernel's plain version on the very
                operands the path handed it (<= 1e-11; an F kernel's upper
                tiles exact zeros), so each kernel is checked at every
                shape its paths give it; the checks' seconds are reported
                apart and taken out of the preprocess time, and the path's
                peak device memory excludes them. Per configuration and
                preconditioner, every
                path takes a PCPG iteration count within one of the first;
                the packed heat-2d ``--kernels`` run's peak device memory
                must be at most half of the dense run's; Dirichlet must take
                fewer iterations than lumped on feti-elasticity-3d.

Then one JSON line with the kernels' numbers (each row: the heat-2d
phase's, ``launches`` summed over the main paths beside
``launches_per_path``, the main paths' checks under ``path_checks``, and
the Dirichlet phase's under ``dirichlet_heat_3d``) and, last, the device
line.
The port imports no JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import dataclasses
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

# feti-heat-3d's validated depth (full: 4,4,4), registered under its own
# architecture name: the width stays the configuration's
HEAT3D_SUB_GRID = (3, 3, 3)
HEAT3D_CUT = "feti-heat-3d-cut"

KERNEL_NAMES = ("stepped_trsm", "stepped_syrk", "stepped_trsm_packed",
                "stepped_trsm_syrk", "stepped_trsm_syrk_packed")

# (name, arch, launcher flags, the launches its path must make: every
# kernel not named must not launch)
MAIN_RUNS = (
    ("heat-2d dense --kernels", ARCH, ["--kernels"],
     dict(stepped_trsm=1, stepped_syrk=1)),
    ("heat-2d packed --kernels", ARCH, ["--storage", "packed", "--kernels"],
     dict(stepped_trsm_packed=1, stepped_syrk=1)),
    ("heat-2d dense --fused", ARCH, ["--fused"], dict(stepped_trsm_syrk=1)),
    ("heat-2d packed --fused", ARCH, ["--storage", "packed", "--fused"],
     dict(stepped_trsm_syrk_packed=1)),
    ("elasticity-2d dense --kernels dirichlet", "feti-elasticity-2d",
     ["--kernels", "--precond", "dirichlet"],
     dict(stepped_trsm=2, stepped_syrk=2)),
    ("elasticity-2d packed --fused dirichlet", "feti-elasticity-2d",
     ["--storage", "packed", "--fused", "--precond", "dirichlet"],
     dict(stepped_trsm_syrk_packed=2)),
    ("elasticity-3d packed --kernels dirichlet", "feti-elasticity-3d",
     ["--storage", "packed", "--kernels", "--precond", "dirichlet"],
     dict(stepped_trsm_packed=2, stepped_syrk=2)),
    ("elasticity-3d dense --fused dirichlet", "feti-elasticity-3d",
     ["--fused", "--precond", "dirichlet"], dict(stepped_trsm_syrk=2)),
    ("elasticity-3d dense --kernels lumped", "feti-elasticity-3d",
     ["--kernels"], dict(stepped_trsm=1, stepped_syrk=1)),
    ("heat-3d dense --kernels dirichlet", HEAT3D_CUT,
     ["--kernels", "--precond", "dirichlet"],
     dict(stepped_trsm=2, stepped_syrk=2)),
)
# runs whose iteration counts must agree within one: the same
# configuration and preconditioner
SAME_SOLVE = (
    ("heat-2d dense --kernels", "heat-2d packed --kernels",
     "heat-2d dense --fused", "heat-2d packed --fused"),
    ("elasticity-2d dense --kernels dirichlet",
     "elasticity-2d packed --fused dirichlet"),
    ("elasticity-3d packed --kernels dirichlet",
     "elasticity-3d dense --fused dirichlet"),
)
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


def stepped_inputs(S, env, L, packed, B, device):
    """The kernels' operands as the assembler hands them over: the padded
    dense factor ``L`` (S, n, n) and its diagonal inverses, its ``packed``
    form, the right-hand side ``B`` (S, n, m) already in stepped column
    order padded to block multiples (padded entries exact zeros), the
    start blocks and both fused item lists."""
    import torch

    from repro_torch.kernels import ops

    bs, bm = env.block_size, env.rhs_block_size
    n_pad, m_pad = -(-env.n // bs) * bs, -(-env.m // bm) * bm
    Lp = ops.pad_factor(L, n_pad)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts_np = ops._start_blocks(env, bm, bs, m_pad, n_pad)
    orders = (ops._fused_order(env, S, device),
              ops._fused_order(env, S, device, packed.index))
    torch.cuda.synchronize()
    return dict(S=S, env=env, bs=bs, bm=bm, n_pad=n_pad, m_pad=m_pad,
                Lp=Lp, Bp=Bp, Linv=ops.invert_diag_blocks(Lp, bs),
                packed=packed, packed_ops=ops._packed_operands(packed, env),
                starts=torch.as_tensor(starts_np, device=device),
                starts_np=starts_np, orders=orders)


def kernel_inputs(device):
    """The dual stage's stepped operands the feti-heat-2d main paths build,
    from a real full-size factorization (implicit mode: no assembly, no
    kernel), and the same factor packed in the fill-mask layout."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, preprocess_cluster
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
    packed = pack_factor(st.L, st.index)
    Bpp = torch.gather(st.Btp, 2, st.col_perm[:, None, :].expand_as(st.Btp))
    S, env, L = st.S, st.env, st.L
    del st
    return stepped_inputs(S, env, L, packed, Bpp, device)


def dirichlet_inputs(device):
    """The Dirichlet stage's stepped operands of the full-size feti-heat-3d
    configuration, cut from each subdomain's K as the preprocessor cuts
    them (``DirichletBlocks``): the interior factor from the stage's own
    block Cholesky (dense, and packed in the interior fill-mask layout),
    K_ib in stepped column order, and K_bb. Also returns what the S_b
    check needs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import dirichlet as dirlib
    from repro_torch.sparse import PackedBlockIndex, block_cholesky, pack_factor

    fc = get_config("feti-heat-3d")
    bs, bm = fc.block_size, fc.rhs_block_size
    t0 = time.perf_counter()
    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid, fc.elems_per_sub)
    t1 = time.perf_counter()
    split = dirlib.boundary_interior_split(prob)
    meta, mask = dirlib.dirichlet_symbolic(prob, split, bs, bm)
    S, n = prob.n_subdomains, split.n
    n_lambda, m_max = prob.n_lambda, prob.m_max
    blocks = dirlib.DirichletBlocks(split, S, device, interior=True
                                    ).upload(prob)
    del prob
    L = block_cholesky(blocks.Kii, bs, mask=mask)
    torch.cuda.synchronize()
    print(f"[chip_smoke] feti-heat-3d {fc.sub_grid} x {fc.elems_per_sub}: "
          f"host decomposition {t1 - t0:.2f}s; split, K upload and interior "
          f"factorization {time.perf_counter() - t1:.2f}s; S={S} n={n} "
          f"n_lambda={n_lambda} m_max={m_max} "
          f"n_i={split.n_i} n_b={split.n_b} interior blocks "
          f"{int(mask.sum())}/{mask.shape[0] * (mask.shape[0] + 1) // 2}",
          flush=True)
    packed = pack_factor(L, PackedBlockIndex.from_mask(mask, split.n_i, bs))
    B = blocks.Kib[:, :, torch.as_tensor(meta.perm, device=device)]
    x = stepped_inputs(S, meta, L, packed, B, device)
    del B
    del L
    x.update(split=split, mask=mask, Kib=blocks.Kib, Kbb=blocks.Kbb)
    return x


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


def check_kernels(x, ptxas, label):
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
    print(f"[chip_smoke] {label} shapes: S={x['S']} n={x['env'].n} "
          f"n_pad={n_pad} m={x['env'].m} m_pad={m_pad} "
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
        print(f"[chip_smoke] {label} {name}: "
              f"max|out|={got.abs().max().item():.3e} "
              f"max|kernel-plain|={abs_err:.3e} rel={rel_err:.3e} rel vs "
              f"twin={twin_err:.3e} rel vs library={lib_err:.3e}"
              + (f" upper tiles zero={zero_ok}" if is_F else ""), flush=True)
        if not (rel_err <= REL_TOL and twin_err <= REL_TOL
                and lib_err <= LIB_TOL and zero_ok
                and bool(torch.isfinite(got).all())):
            raise SystemExit(f"{label} {name} disagrees: rel {rel_err:.3e} "
                             f"to its "
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
        print(f"[chip_smoke] {label} {name}: {ms:.3f} ms (plain "
              f"{plain_ms:.3f}, "
              f"library {library_ms:.3f}, bound {b['bound_ms']:.3f} by "
              f"{b['bound_by']}: {b['flops']:.4e} f64 flop at "
              f"{PEAK_FP64_FLOPS / 1e12:g} TFLOP/s, {b['bytes']:.4e} B at "
              f"{PEAK_BYTES_PER_S / 1e12:g} TB/s)", flush=True)
        print(f"[chip_smoke] {label} {name}: {tflops:.2f} useful TFLOP/s, "
              f"{100 * b['bound_ms'] / ms:.1f}% of the bound, "
              f"{library_ms / ms:.2f}x the library call's speed"
              + (f"; unfused pair back to back {pair_ms:.3f} ms "
                 f"({pair_ms / ms:.2f}x the fused time)"
                 if pair_ms is not None else ""), flush=True)
    return rows


def check_dirichlet_sb(x):
    """S_b = K_bb - K_bi K_ii^-1 K_ib of the full-size feti-heat-3d stage,
    from the stage's assembler given the interior factor: through the
    kernels (B1+B2, B4; B3+B2, B5) against the plain variants (the
    factor-split TRSM and input-split SYRK in torch ops)."""
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.feti import dirichlet as dirlib

    env = x["env"]
    dense = x["Lp"][:, :env.n, :env.n]

    def sb(storage, **kw):
        cfg = SchurAssemblyConfig(block_size=x["bs"], rhs_block_size=x["bm"],
                                  storage=storage, **kw)
        assemble = dirlib.make_dirichlet_assembler(
            x["split"], env, x["mask"], cfg, shared=True)
        factor = x["packed"] if storage == "packed" else dense
        return assemble(factor, x["Kib"], x["Kbb"])

    want = sb("dense")
    errs = {}
    for label, storage, kw in (
            ("dense, B1 then B2", "dense", dict(use_kernels=True)),
            ("dense, fused B4", "dense", dict(use_kernels=True, fused=True)),
            ("packed, B3 then B2", "packed", dict(use_kernels=True)),
            ("packed, fused B5", "packed", dict(use_kernels=True, fused=True))):
        errs[label] = compare(sb(storage, **kw), want)[1]
    print(f"[chip_smoke] dirichlet S_b ({want.shape[1]} x {want.shape[2]} "
          f"per subdomain, max|S_b|={want.abs().max().item():.3e}) rel to "
          f"the plain variants: {errs}", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
    if bad:
        raise SystemExit(f"dirichlet S_b disagrees with the plain variants: "
                         f"{bad}")


def _counters():
    from repro_torch import kernels

    return {name: getattr(kernels, f"{name}_kernel") for name in KERNEL_NAMES}


@contextlib.contextmanager
def checked_launches():
    """Within the block, every wrapper ``ops`` calls launches its kernel as
    before and then, once the launch has finished, its output is held
    against the kernel's plain version on the very same operands (the
    plain versions launch nothing, so the counts stay the path's own).
    Yields a dict: ``records``, one per launch (kernel, padded shape
    (S, n_pad, m_pad), errors, pass); ``check_s``, the checks' own
    seconds; ``peak``, the device peak outside the checks (each check
    resets the peak counter once its operands are freed)."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops

    state = dict(records=[], check_s=0.0, peak=0)

    def wrap(name, kernel, plain):
        def checked(*args, order=None, **kw):
            out = (kernel(*args, **kw) if order is None
                   else kernel(*args, order=order, **kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["peak"] = max(state["peak"], torch.cuda.max_memory_allocated())
            want = plain(*args, **kw)
            abs_err, rel_err = compare(out, want)
            del want
            B = args[-2]  # the right-hand side (or Y): (S, n_pad, m_pad)
            zero_ok = (upper_tiles_zero(out, kw["bm"], B.shape[2])
                       if name in F_KERNELS else True)
            ok = (rel_err <= REL_TOL and zero_ok
                  and bool(torch.isfinite(out).all()))
            state["records"].append(dict(
                kernel=name, shape=list(B.shape), max_abs_err=abs_err,
                max_rel_err=rel_err, ok=ok))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state["check_s"] += time.perf_counter() - t0
            return out
        return checked

    saved = {name: getattr(ops, f"{name}_kernel") for name in KERNEL_NAMES}
    for name, kernel in saved.items():
        setattr(ops, f"{name}_kernel",
                wrap(name, kernel, getattr(kernels, f"{name}_plain")))
    try:
        yield state
    finally:
        for name, kernel in saved.items():
            setattr(ops, f"{name}_kernel", kernel)
        state["peak"] = max(state["peak"], torch.cuda.max_memory_allocated())


def run_main_path(name, arch, flags, expected):
    """Drive the launcher with ``--validate``, every kernel launch checked
    against its plain version (:func:`checked_launches`); returns this
    run's launch counts, checks, iteration count, peak device memory and
    sharing decision."""
    import torch

    from repro_torch.launch import solve_feti

    argv = ["--arch", arch, *flags, "--validate"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    with checked_launches() as checks, contextlib.redirect_stdout(buf):
        rc = solve_feti.main(argv)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = checks["peak"]
    out = buf.getvalue()
    print(out, end="", flush=True)
    for r in checks["records"]:
        print(f"[chip_smoke] main path {name} launch check {r['kernel']} at "
              f"(S, n_pad, m_pad)={tuple(r['shape'])}: max|kernel-plain|="
              f"{r['max_abs_err']:.3e} rel={r['max_rel_err']:.3e}"
              + ("" if r["ok"] else " FAILED"), flush=True)
    if rc != 0:
        raise SystemExit(f"solve_feti {' '.join(argv)} exited {rc}")
    bad = [r for r in checks["records"] if not r["ok"]]
    if bad:
        raise SystemExit(f"{name}: kernel launches disagree with their plain "
                         f"versions (rel > {REL_TOL:g}, nonzero upper tiles "
                         f"or non-finite): {bad}")
    m_iters = re.search(r"iters=(\d+) residual=(\S+) converged=(\w+)", out)
    m_err = re.search(r"rel err vs global solve: (\S+)", out)
    m_time = re.search(r"preprocess=(\S+)s solve=(\S+)s", out)
    m_shared = re.search(r"shared_factor=(\w+)", out)
    if not (m_iters and m_err and m_time) or m_iters.group(3) != "True":
        raise SystemExit(f"{name}: solve_feti did not report a converged, "
                         f"validated solve")
    err = float(m_err.group(1))
    if not err <= 1e-6:
        raise SystemExit(f"{name}: relative error {err:.3e} > 1e-6")
    want = {k: expected.get(k, 0) for k in KERNEL_NAMES}
    if launches != want:
        raise SystemExit(f"{name}: launched {launches}, the path must "
                         f"launch {want}")
    checked = {}
    for r in checks["records"]:
        checked[r["kernel"]] = checked.get(r["kernel"], 0) + 1
    if checked != {k: v for k, v in want.items() if v}:
        raise SystemExit(f"{name}: checked {checked}, launched {launches}")
    shared = m_shared.group(1) if m_shared else "n/a (lumped)"
    # the launcher's preprocess seconds include the launch checks
    prep = float(m_time.group(1)) - checks["check_s"]
    print(f"[chip_smoke] main path {name}: iterations={m_iters.group(1)} "
          f"converged=True rel_err={err:.3e} "
          f"preprocess_s={prep:.2f} (launcher {m_time.group(1)} less "
          f"{checks['check_s']:.2f} of launch checks) "
          f"solve_s={m_time.group(2)} "
          f"peak_device_bytes={peak:,} shared_factor={shared} "
          f"launches={ {k: v for k, v in launches.items() if v} }",
          flush=True)
    return dict(launches=launches, iterations=int(m_iters.group(1)),
                peak=peak, checks=checks["records"])


def register_heat3d_cut():
    """Register feti-heat-3d at the validated depth HEAT3D_SUB_GRID as the
    architecture HEAT3D_CUT (the width and every other field unchanged)."""
    from repro_torch.configs import get_config, register

    cut = dataclasses.replace(get_config("feti-heat-3d"), name=HEAT3D_CUT,
                              sub_grid=HEAT3D_SUB_GRID)
    register(HEAT3D_CUT, lambda: cut, lambda: cut)


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

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t0 = phase("kernels")
    x = kernel_inputs(device)
    rows = check_kernels(x, ptxas, "heat-2d dual")
    del x
    free()
    done("kernels", t0)

    t0 = phase("dirichlet")
    x = dirichlet_inputs(device)
    d_rows = check_kernels(x, ptxas, "heat-3d dirichlet")
    check_dirichlet_sb(x)
    print(f"[chip_smoke] dirichlet phase peak device bytes "
          f"{torch.cuda.max_memory_allocated():,}", flush=True)
    del x
    free()
    done("dirichlet", t0)

    t0 = phase("main")
    register_heat3d_cut()
    runs = {}
    for name, arch, flags, expected in MAIN_RUNS:
        runs[name] = run_main_path(name, arch, flags, expected)
    for group in SAME_SOLVE:
        its = {name: runs[name]["iterations"] for name in group}
        if max(its.values()) - min(its.values()) > 1:
            raise SystemExit(f"iteration counts more than one apart: {its}")
    base = runs["heat-2d dense --kernels"]
    packed = runs["heat-2d packed --kernels"]
    ratio = packed["peak"] / base["peak"]
    print(f"[chip_smoke] peak device memory, heat-2d packed / dense "
          f"--kernels: {packed['peak']:,} / {base['peak']:,} = {ratio:.3f}",
          flush=True)
    if ratio > 0.5:
        raise SystemExit("the packed run's peak device memory is above half "
                         "of the dense run's")
    lumped = runs["elasticity-3d dense --kernels lumped"]["iterations"]
    dirichlet = runs["elasticity-3d packed --kernels dirichlet"]["iterations"]
    print(f"[chip_smoke] feti-elasticity-3d iterations: dirichlet {dirichlet}, "
          f"lumped {lumped}", flush=True)
    if not dirichlet < lumped:
        raise SystemExit("Dirichlet took no fewer iterations than lumped on "
                         "feti-elasticity-3d")
    done("main", t0)

    keep = ("ms", "plain_ms", "library_ms", "library_call", "bound_ms",
            "bound_by", "tflops", "bound_share", "max_abs_err", "max_rel_err",
            "twin_rel_err", "library_rel_err", "unfused_pair_ms")
    for r, d in zip(rows, d_rows):
        per_path = {name: run["launches"][r["name"]]
                    for name, run in runs.items() if run["launches"][r["name"]]}
        r["launches"] = sum(per_path.values())
        r["launches_per_path"] = per_path
        r["path_checks"] = {
            name: [dict(shape=c["shape"], max_abs_err=c["max_abs_err"],
                        max_rel_err=c["max_rel_err"])
                   for c in run["checks"] if c["kernel"] == r["name"]]
            for name, run in runs.items() if name in per_path}
        r["dirichlet_heat_3d"] = {k: d[k] for k in keep}
    print(f"[chip_smoke] total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
