"""Time variants of the stepped kernels' device code side by side.

    python3 tests/torch_trsm_variants.py [--levers row_ring3,panel_kc32,...]
        [--kernels B1,B2,...] [--sources NAME=DIR,...] [--orders rows,ready]
        [--phases bs128,bs16,bs256] [--f64] [--dirichlet]

e.g. B3 f32 against its parent's device code, steps (a) and (b) of its
cluster core (``cluster1``: one block a cluster; "base": the stripe's
tiles as one cluster) at every phase, in one call:

    git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tests/torch_trsm_variants.py --kernels B3 --levers cluster1 \
        --sources parent=build/parent/src/repro_torch/kernels/csrc --dirichlet

(``--levers cluster_count,cluster1_count`` also counts, on the card, the
factor, Linv and Y bytes that steps (b) and (a) copy in one launch.)

Each lever is a set of substitutions in the sources of
``src/repro_torch/kernels/csrc`` (a constant, a launch bound, a loop's
unrolling, the accumulation, the fused kernels' wait; LEVERS lists them).
The script copies the sources once per lever into
``build/trsm_variants/<lever>/``, applies the substitutions (a text that
is not found stops it), builds every variant's TRSM, SYRK and fused
libraries at once through ``repro_torch.kernels.build`` and prints each
instance's registers and spills. ``--sources`` adds whole source trees as
variants (a copy of ``csrc/`` from another commit, unpacked with ``git
archive``: its kernels keep the same C interface). Then, on feti-heat-2d's
full-size factor (``chip_smoke.kernel_inputs``) at bs = 128 (f32), at
bs = bm = 16 (``chip_smoke.reblocked_inputs``; f32 and f64) and, with
``--phases bs256``, at bs = bm = 256 (f32; ``--f64`` adds f64 at every
phase; ``--phases`` picks some), it runs the stepped
TRSM (B1), the stepped SYRK (B2, on the plain TRSM's Y), the packed TRSM
(B3) and both fused kernels (B4, B5) of every variant ("base": the
sources as they are; ``--kernels`` picks some) through the port's own
wrappers inside ``build.sources(<the variant's copy>)``, holds each
against its plain version (chip_smoke's F32_TOL and REL_TOL; a
TIMING_ONLY lever's disagreement is printed, not counted) and prints its
CUDA-event median time; an f32 TRSM's or SYRK's distance from the f64
kernel on the same operands is printed beside its chip_smoke bar
(F32_TRSM_TWIN_TOL, F32_SYRK_TWIN_TOL). ``--orders`` times the fused
kernels (B4, B5) of every variant on each named order of their SYRK items
(ORDERS: "rows", the list as ``kernels/schedule.py`` builds it; "ready",
its SYRK items re-sorted so that those whose TRSM tiles cost least, and so
are solved first, come first). ``--dirichlet`` adds the kernels on the
full-size feti-heat-3d Dirichlet stage's operands
(``chip_smoke.dirichlet_inputs``, ~17 GB of host memory). Compare
variants only within one run. Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import gc
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "trsm_variants")
LIBS = ("stepped_trsm", "stepped_syrk", "stepped_trsm_syrk")
KERNELS = ("B1", "B2", "B3", "B4", "B5")

# lever: [(text in the sources, its replacement), ...]
ROW_KC = "constexpr int ROW_KC = sizeof(T) == 8 ? 16 : 32;"
ROW_STAGES = "constexpr int ROW_STAGES = sizeof(T) == 8 ? 3 : 2;"
PKC = "constexpr int PKC = sizeof(T) == 8 ? 32 : 64;"
K8_LOOP = """  static_assert(MI % 2 == 0 && KDEPTH % 8 == 0, "m16n8k8 tiles");
#pragma unroll 1
  for (int k = 0; k < KDEPTH; k += 8) {
    uint32_t a_hi"""
CLUSTER_MAX = "constexpr int MAX_CLUSTER = 4;"
CLUSTER_POLICY = "cudaClusterSchedulingPolicyLoadBalancing;"
CLUSTER_RING = "constexpr int RING = (PASSES == 1 ? 2 : 3) * (MAX_KC / KC);"
CLUSTER_K8 = """#pragma unroll 1
  for (int k = 0; k < KC; k += 8) {"""
SYRK_KC = "constexpr int SYRK_KC = sizeof(T) == 4 && TM == 128 ? 32 : 16;"
# counters in the cluster core of the bytes its factor and Linv boxes bring
# from global memory (once a load, however many blocks a multicast
# reaches) and of the Y bytes each block copies, read and zeroed by
# stepped_trsm_cluster_counted
CLUSTER_COUNT = [
    ("constexpr int ENCODE_FAILED = 10000;",
     "constexpr int ENCODE_FAILED = 10000;\n"
     "__device__ unsigned long long counted_bytes[3];  // factor, Linv, Y"),
    ("""          tma_load(smem_u32(As + st * A_ST), map, x, y, ring.full(st),
                   cluster);
""", """          tma_load(smem_u32(As + st * A_ST), map, x, y, ring.full(st),
                   cluster);
          atomicAdd(&counted_bytes[Yj ? 0 : 1], (unsigned long long)tx);
"""),
    ("""      if (lane == 0) {
        mbar_expect_tx(ring.full(st), tx);""",
     """      if (lane == 0) {
        if (Yj)
          atomicAdd(&counted_bytes[2],
                    (unsigned long long)(KC * width * sizeof(float)));
        mbar_expect_tx(ring.full(st), tx);"""),
    ('extern "C" int stepped_trsm_cluster_tiles(int bm) {',
     """extern "C" int stepped_trsm_cluster_counted(unsigned long long* out) {
  const unsigned long long zero[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, trsm_cluster::counted_bytes,
                                         sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(trsm_cluster::counted_bytes, zero, sizeof zero);
  return (int)err;
}

extern "C" int stepped_trsm_cluster_tiles(int bm) {""")]
# chip_smoke's label of each phase (F32_SYRK_TWIN_TOL's keys)
PHASES = {"bs128": "heat-2d dual", "bs16": "heat-2d dual bs=16",
          "bs256": "heat-2d dual bs=256", "dirichlet": "heat-3d dirichlet"}
# the f32 SYRK tile split once a chunk, at staging, into TF32 hi and lo
# panels (hi over the f32 values, lo in a buffer after the ring), the
# products reading the split values; f64 unchanged
SYRK_MMA = """        if (k_begin + (c + 1) * KC > k_warp)
          tile::mma<MI, NJ, KC, 1, LD, LD, false>(acc, Pi + wm0, Pj + wn0);"""
SYRK_SPLIT_STAGED = """        if constexpr (sizeof(T) == 4) {
          T* hi = smem + stage * 2 * PANEL;
          T* lo = smem + SYRK_STAGES * 2 * PANEL;
          for (int e = tid; e < (diag ? 1 : 2) * PANEL; e += NTHREADS) {
            uint32_t h, l;
            tf32x3::split(hi[e], h, l);
            hi[e] = __uint_as_float(h);
            lo[e] = __uint_as_float(l);
          }
          __syncthreads();
          if (k_begin + (c + 1) * KC > k_warp)
            tf32x3::warp_mma_presplit<MI, NJ, KC, 1, LD, LD>(
                acc, hi + wm0, lo + wm0, (diag ? hi : hi + PANEL) + wn0,
                lo + (diag ? 0 : PANEL) + wn0);
        } else {
""" + SYRK_MMA + """
        }"""
PRESPLIT = """
// warp_mma on operands split beforehand: A = Ahi + Alo, B = Bhi + Blo
template <int MI, int NJ, int KDEPTH, int A_RS, int A_KS, int LDB>
__device__ __forceinline__ void warp_mma_presplit(
    float (&acc)[MI][NJ][2], const float* Ahi, const float* Alo,
    const float* Bhi, const float* Blo) {
  const int g = dmma::lane_g(), t = dmma::lane_t();
#pragma unroll 1
  for (int k = 0; k < KDEPTH; k += 8) {
    uint32_t a_hi[MI / 2][4], a_lo[MI / 2][4], b_hi[NJ][2], b_lo[NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = (16 * i + 8 * (q & 1) + g) * A_RS +
                      (k + t + 4 * (q >> 1)) * A_KS;
        a_hi[i][q] = __float_as_uint(Ahi[o]);
        a_lo[i][q] = __float_as_uint(Alo[o]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int o = (k + t + 4 * q) * LDB + 8 * j + g;
        b_hi[j][q] = __float_as_uint(Bhi[o]);
        b_lo[j][q] = __float_as_uint(Blo[o]);
      }
    float step[MI][NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8_new(step[2 * i][j], step[2 * i + 1][j], a_lo[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(step[2 * i][j], step[2 * i + 1][j], a_hi[i], b_lo[j]);
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(step[2 * i][j], step[2 * i + 1][j], a_hi[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j][0] += step[i][j][0];
        acc[i][j][1] += step[i][j][1];
      }
  }
}

}  // namespace tf32x3"""
FUSED_SYRK_CALL = "    syrk_tile<T, LoadFromL2, FUSED_TILE, 32, 32, THREADS>("
FUSED_WAIT = "        while (!load_acquire(flags + c)) __nanosleep(128);"
POLL_RELAXED = """__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

"""
LEVERS = {
    "base": [],
    # the f32 row-split core's ring 3 deep (two blocks a SM)
    "row_ring3": [(ROW_STAGES, "constexpr int ROW_STAGES = 3;")],
    # its chunks 16 deep (as at f64)
    "row_kc16": [(ROW_KC, "constexpr int ROW_KC = 16;")],
    # its chunks 64 deep (110 KB of shared memory: two blocks a SM)
    "row_kc64": [(ROW_KC, "constexpr int ROW_KC = sizeof(T) == 8 ? 16 : 64;")],
    # the panel core's f32 chunks 32 deep (as at f64)
    "panel_kc32": [(PKC, "constexpr int PKC = 32;")],
    # the 3xTF32 products accumulated along the whole reduction on the
    # tensor cores (truncating), not a k8 step at a time
    "chain_acc": [
        ("mma_16x8x8_new(step[2 * i][j], step[2 * i + 1][j],",
         "mma_16x8x8(acc[2 * i][j], acc[2 * i + 1][j],"),
        ("mma_16x8x8(step[2 * i][j], step[2 * i + 1][j],",
         "mma_16x8x8(acc[2 * i][j], acc[2 * i + 1][j],"),
        ("acc[i][j][0] += step[i][j][0];", ""),
        ("acc[i][j][1] += step[i][j][1];", ""),
        ("mma_16x8x8_new(t0, t1,", "mma_16x8x8(d0, d1,"),
        ("mma_16x8x8(t0, t1,", "mma_16x8x8(d0, d1,"),
        ("d0[0] += t0[0];", ""), ("d0[1] += t0[1];", ""),
        ("d1[0] += t1[0];", ""), ("d1[1] += t1[1];", "")],
    # the 3xTF32 product's k8 steps unrolled (the TRSM core's and the
    # SYRK tile's)
    "k_unroll": [(K8_LOOP, K8_LOOP.replace("#pragma unroll 1",
                                           "#pragma unroll"))],
    # the f32 stepped SYRK's chunks 16 rows deep (as at f64)
    "syrk_kc16": [(SYRK_KC, "constexpr int SYRK_KC = 16;")],
    # the fused kernels' SYRK items' chunks 32 rows deep at both dtypes
    # (the f64 stepped SYRK's stay 16)
    "fused_kc32": [(SYRK_KC, "constexpr int SYRK_KC = "
                             "sizeof(T) == 8 && TM == 128 ? 16 : 32;")],
    # no warp of the SYRK tile skips the chunks above its rows' starts
    "syrk_no_skip": [("if (k_begin + (c + 1) * KC > k_warp)", "if (true)")],
    "syrk_split_staged": [
        (SYRK_MMA, SYRK_SPLIT_STAGED),
        ("}  // namespace tf32x3", PRESPLIT),
        ("return sizeof(T) * SYRK_STAGES * 2 * SYRK_KC<T, TM> * SYRK_LD<T, TM>;",
         "return sizeof(T) * (SYRK_STAGES + 1) * 2 * SYRK_KC<T, TM> *\n"
         "         SYRK_LD<T, TM>;")],
    # timing only (their F is wrong, reported and not counted as a
    # failure; TIMING_ONLY): the fused kernels' SYRK items skipped, which
    # leaves the TRSM half's time in the fused launch, and their SYRK
    # items run without waiting for their TRSM tiles, which leaves the
    # cost of both halves without their dependencies
    "fused_no_syrk": [(FUSED_SYRK_CALL,
                       "    if (n < 0) " + FUSED_SYRK_CALL.strip())],
    "fused_no_wait": [(FUSED_WAIT, "        (void)load_acquire(flags + c);")],
    # the fused kernels' SYRK items poll their ready flags with relaxed
    # loads and acquire once a flag reads set (an ld.acquire.gpu a poll
    # otherwise)
    "fused_poll_relaxed": [
        ("__device__ __forceinline__ int load_acquire(const int* p) {",
         POLL_RELAXED + "__device__ __forceinline__ int load_acquire("
                        "const int* p) {"),
        (FUSED_WAIT,
         "        while (!load_relaxed(flags + c) || !load_acquire(flags + c))\n"
         "          __nanosleep(128);")],
    # the fused kernels' SYRK items poll every microsecond, not 128 ns
    "fused_sleep1us": [("__nanosleep(128);", "__nanosleep(1024);")],
    # launch bounds asking for three blocks a SM (every instance)
    "bound3": [("__launch_bounds__(THREADS)",
                "__launch_bounds__(THREADS, 3)")],
    # the panel and k-split cores' rings 2 deep
    "small_ring2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    # the packed f32 TRSM's cluster core with one block a cluster: its TMA
    # ring and producer warp alone, every tile loading its own chunks (step
    # (a) of its design; "base" is step (b))
    "cluster1": [(CLUSTER_MAX, CLUSTER_MAX.replace("4", "1"))],
    # clusters of at most two and eight blocks
    "cluster2": [(CLUSTER_MAX, CLUSTER_MAX.replace("4", "2"))],
    "cluster8": [(CLUSTER_MAX, CLUSTER_MAX.replace("4", "8"))],
    # steps (b) and (a) counting the bytes their chunks copy (printed
    # beside chip_smoke.chunk_bytes' reckoning of them)
    "cluster_count": CLUSTER_COUNT,
    "cluster1_count": [(CLUSTER_MAX, CLUSTER_MAX.replace("4", "1")),
                       *CLUSTER_COUNT],
    # clusters whose blocks share nothing: each loads its own boxes and
    # waits for no other block (what the cluster launch costs without the
    # multicast and its waits)
    "cluster_no_share": [
        ("        if (lane < cluster) mbar_arrive_remote(ring.empty(st), lane);\n",
         ""),
        ("        if (q % cluster == rank) {\n"
         "          if (q >= RG) mbar_wait(ring.empty(st), parity);",
         "        {"),
        ("ring.full(st),\n                   cluster);",
         "ring.full(st),\n                   1);")],
    # the other cluster scheduling preferences
    "cluster_spread": [(CLUSTER_POLICY, "cudaClusterSchedulingPolicySpread;")],
    "cluster_default": [(CLUSTER_POLICY,
                         "cudaClusterSchedulingPolicyDefault;")],
    # the one-pass ring twice as deep (two blocks a SM)
    "cluster_ring4": [(CLUSTER_RING, CLUSTER_RING.replace("? 2 : 3", "? 4 : 3"))],
    # chunks at most 16 deep
    "cluster_kc16": [("constexpr int MAX_KC = 32;",
                      "constexpr int MAX_KC = 16;")],
    # its k8 steps unrolled by two
    "cluster_unroll2": [(CLUSTER_K8, CLUSTER_K8.replace("unroll 1",
                                                        "unroll 2"))],
    # timing only (TIMING_ONLY): the cluster core's consumers skip their
    # products, which leaves the ring's copies and barriers; its producer
    # takes no hand-over of Y, which leaves the rows' dependence out
    "cluster_no_mma": [("          if (active)\n            mma_chunk<KC, true>",
                        "          if (n < 0)\n            mma_chunk<KC, true>"),
                       ("if (active && c * KC < pr0 + wr0 + WROWS)",
                        "if (n < 0)")],
    "cluster_no_wait": [("          need(j);\n", ""),
                        ("      need(k - 1);\n", "")],
}


TIMING_ONLY = ("fused_no_syrk", "fused_no_wait", "cluster_no_mma",
               "cluster_no_wait")
ORDERS = ("rows", "ready")


def ready_first(xx, index=None):
    """The fused kernels' item list for ``xx``'s plan (with the packed
    ``index``: B5's) with its SYRK items re-sorted: those whose costliest
    TRSM tile (of the column tiles the item waits for) costs least first,
    ties broken by the most rows to reduce, as the schedule's own order.
    The TRSM items stay first, as freedom from deadlock needs."""
    import numpy as np

    from repro_torch.kernels._launch import FUSED_SYRK_TILE as T
    from repro_torch.kernels._launch import TILE
    from repro_torch.kernels.schedule import (
        fused_groups,
        fused_work_order,
        trsm_stripe_costs,
    )

    S, bm, m = xx["S"], xx["bm"], xx["m_pad"]
    nb, starts = xx["n_pad"] // xx["bs"], xx["starts_np"]
    csr = (index.rowptr, index.cols) if index is not None else ()
    base = fused_work_order(starts, S, nb, m, bm, *csr)
    col_tiles = -(-m // TILE)
    g, groups, subs = fused_groups(m, bm)
    width = g * bm
    tile_cost = trsm_stripe_costs(starts, nb, *csr)[
        np.arange(col_tiles) * TILE // bm]
    ready, rows = [], []
    for gi in range(groups):
        for gj in range(gi + 1):
            for sub in range(subs * subs):
                r0 = gi * width + (sub // subs) * T
                c0 = gj * width + (sub % subs) * T
                r1 = min(r0 + T, (gi + 1) * width, m)
                c1 = min(c0 + T, (gj + 1) * width, m)
                tiles = [*range(r0 // TILE, -(-r1 // TILE)),
                         *range(c0 // TILE, -(-c1 // TILE))]
                ready.append(tile_cost[tiles].max())
                rows.append(nb - min(int(starts[gi * g]), nb))
    perm = np.lexsort((-np.tile(rows, S), np.tile(ready, S)))
    n_trsm = S * col_tiles
    return np.concatenate([base[:n_trsm], perm + n_trsm]).astype(np.int32)


# the library each kernel is built in
KERNEL_LIBS = {"B1": "stepped_trsm", "B2": "stepped_syrk", "B3": "stepped_trsm",
               "B4": "stepped_trsm_syrk", "B5": "stepped_trsm_syrk"}


def build(levers, sources=None, libs=LIBS):
    """The sources of each lever (``build/trsm_variants/<lever>``; "base"
    the port's own) and of each named tree in ``sources``, their libraries
    built all at once; returns
    ({lever: source directory}, {(lever, kernel, dtype, chunk, factor):
    (registers, spill bytes)}; the stepped SYRK's chunk 0, factor "-")."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build as kbuild

    dirs = {}
    for lever in levers:
        if not LEVERS[lever]:
            dirs[lever] = CSRC
            continue
        d = os.path.join(OUT, lever)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        for old, new in LEVERS[lever]:
            hits = 0
            for name in os.listdir(d):
                path = os.path.join(d, name)
                text = open(path).read()
                hits += old in text
                open(path, "w").write(text.replace(old, new))
            if not hits:
                raise SystemExit(f"lever {lever}: {old!r} not found")
        dirs[lever] = d
    dirs.update(sources or {})
    # a library whose sources no lever changed is built once, not by two
    # threads into the same path
    claimed, jobs = set(), []
    for d in dirs.values():
        todo = [lib for lib in libs
                if kbuild._library_path(lib, d) not in claimed]
        claimed.update(kbuild._library_path(lib, d) for lib in todo)
        jobs.append((d, todo))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: kbuild.build(job[1], csrc=job[0]), jobs))
    regs = {}
    for lever, d in dirs.items():
        for lib in libs:
            log = kbuild._library_path(lib, d).with_suffix(".log").read_text()
            for block in re.split(r"Compiling entry function", log)[1:]:
                name = block.split("'")[1]
                # <T, KC, PASSES[, Factor]>: the cluster core has no
                # factor accessor
                m = re.search(r"([a-z_]+_kernel)I([fd])Li(\d+)ELi(\d+)E"
                              r"(?:N7stepped\d+(\w+?)I)?", name)
                syrk = re.search(r"(stepped_syrk_kernel)I([fd])E", name)
                used = re.search(r"Used (\d+) registers", block)
                spills = re.findall(r"(\d+) bytes spill stores", block)
                key = ((lever, m.group(1), m.group(2), int(m.group(3)),
                        f"{m.group(5) or 'PackedFactor'} x{m.group(4)}")
                       if m else
                       (lever, syrk.group(1), syrk.group(2), 0, "-") if syrk
                       else None)
                if key and used:
                    regs[key] = (int(used.group(1)),
                                 sum(int(b) for b in spills))
    return dirs, regs


def resident_clusters(dirs, bs=128):
    """Print, for each variant whose library has it, the clusters of 1, 2,
    4 and 8 blocks of the packed f32 TRSM's instance for ``bs`` that the
    card holds at once, and the blocks that makes."""
    import ctypes

    from repro_torch.kernels import build as kbuild

    for v, d in dirs.items():
        with kbuild.sources(d):
            fn = getattr(kbuild.load("stepped_trsm"),
                         "stepped_trsm_cluster_resident", None)
        if fn is None:
            continue
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        cells = []
        for c in (1, 2, 4, 8):
            n = ctypes.c_int(0)
            err = fn(bs, c, ctypes.byref(n))
            cells.append(f"{c}: {n.value} ({c * n.value} blocks)" if not err
                         else f"{c}: CUDA error {err}")
        print(f"{v}: resident clusters at bs {bs}: " + ", ".join(cells),
              flush=True)


def counted_chunks(xx, run):
    """The bytes the packed f32 TRSM's cluster core copies in one ``run``
    as a counting lever's counters count them, beside
    ``chip_smoke.chunk_bytes``' reckoning from the slot walk; None where the
    current build has no counters."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild

    lib = kbuild.load("stepped_trsm")
    read = getattr(lib, "stepped_trsm_cluster_counted", None)
    if read is None:
        return None
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    lib.stepped_trsm_cluster_tiles.argtypes = [ctypes.c_int]
    lib.stepped_trsm_cluster_tiles.restype = ctypes.c_int
    got = (ctypes.c_ulonglong * 3)()
    torch.cuda.synchronize()
    err = read(got)  # zeroes the counters
    run()
    torch.cuda.synchronize()
    err = err or read(got)
    if err:
        raise SystemExit(f"the cluster core's counters: CUDA error {err}")
    c = lib.stepped_trsm_cluster_tiles(xx["bm"])
    f, li, y = cs.chunk_bytes(xx, c)
    return (f"counted factor {got[0]:,} B, Linv {got[1]:,} B, Y {got[2]:,} "
            f"B; reckoned for clusters of {c}: {f:,}, {li:,}, {y:,}")


def time_phase(label, xx, dtypes, dirs, kernels=KERNELS, orders=("rows",)):
    """Each lever's ``kernels`` on one phase's operands ``xx``, launched
    through the port's wrappers from the lever's sources (the fused ones
    once for each of ``orders``), checked against their plain versions and
    timed; returns the disagreements."""
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops

    bad = []
    for dt in dtypes:
        suf = "f32" if dt == torch.float32 else "f64"
        tol = cs.F32_TOL if dt == torch.float32 else cs.REL_TOL
        bs, bm = xx["bs"], xx["bm"]
        Lp = xx["Lp"].to(dt)
        dense = (ops.invert_diag_blocks(Lp, bs), Lp)
        B = xx["Bp"].to(dt)
        packed = ops._packed_operands(xx["packed"].to(dt), xx["env"])
        starts = xx["starts"]
        dev = B.device
        lists = {"rows": xx["orders"]}
        if "ready" in orders:
            lists["ready"] = tuple(
                torch.from_numpy(ready_first(xx, i)).to(dev)
                for i in (None, xx["packed"].index))
        Y = K.stepped_trsm_plain(*dense, B, starts, bs, bm)
        plain = {
            "B1": lambda: Y,
            "B2": lambda: K.stepped_syrk_plain(Y, starts, bs, bm),
            "B3": lambda: K.stepped_trsm_packed_plain(*packed, B, starts, bs,
                                                      bm),
            "B4": lambda: K.stepped_trsm_syrk_plain(*dense, B, starts, bs,
                                                    bm),
            "B5": lambda: K.stepped_trsm_syrk_packed_plain(*packed, B,
                                                           starts, bs, bm)}
        plain = {name: plain[name]() for name in kernels}

        def wide(operands):  # the same values at f64
            return [a.double() if a.is_floating_point() else a
                    for a in operands]

        # the f32 TRSM's and SYRK's yardsticks: the port's f64 kernels on
        # the same values
        f32 = suf == "f32"
        twins = {
            "B1": lambda: K.stepped_trsm_kernel(*wide(dense), B.double(),
                                                starts, bs, bm),
            "B2": lambda: K.stepped_syrk_kernel(Y.double(), starts, bs, bm)}
        twins["B3"] = twins["B1"]
        twins = {name: twins[name]() for name in twins
                 if f32 and name in kernels}
        bars = dict(B1=cs.F32_TRSM_TWIN_TOL,
                    B2=cs.F32_SYRK_TWIN_TOL[PHASES[label]],
                    B3=cs.F32_TRSM_TWIN_TOL)
        def runs(order, porder):
            return {
                "B1": lambda: K.stepped_trsm_kernel(*dense, B, starts, bs,
                                                    bm),
                "B2": lambda: K.stepped_syrk_kernel(Y, starts, bs, bm),
                "B3": lambda: K.stepped_trsm_packed_kernel(*packed, B,
                                                           starts, bs, bm),
                "B4": lambda: K.stepped_trsm_syrk_kernel(
                    *dense, B, starts, bs, bm, order=order),
                "B5": lambda: K.stepped_trsm_syrk_packed_kernel(
                    *packed, B, starts, bs, bm, order=porder)}

        cases = [(v, d, o) for v, d in dirs.items() for o in orders]
        for v, d, o in cases:
            cells = []
            with kbuild.sources(d):
                for name in kernels:
                    if o != orders[0] and name not in ("B4", "B5"):
                        continue
                    run = runs(*lists[o])[name]
                    got = run()
                    torch.cuda.synchronize()
                    err = cs.compare(got, plain[name])[1]
                    if not err <= tol:
                        if v not in TIMING_ONLY:
                            bad.append((label, suf, v, name, err))
                    cell = f"{name} {cs.cuda_ms(run):.3f} ms (rel {err:.1e}"
                    if name in twins:
                        terr = cs.compare(got.double(), twins[name])[1]
                        cell += (f", {terr:.2e} from f64"
                                 + (f" > its bar {bars[name]:g}"
                                    if terr > bars[name] else ""))
                    cells.append(cell + ")")
                    if name == "B3" and f32 and bs > 16:
                        counted = counted_chunks(xx, run)
                        if counted:
                            cells.append(f"B3 chunks: {counted}")
            tag = v if len(orders) == 1 else f"{v} order={o}"
            print(f"{label} {suf} {tag}: " + "; ".join(cells), flush=True)
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--levers", default=",".join(LEVERS),
                   help="comma-separated LEVERS keys (base is always run)")
    p.add_argument("--kernels", default=",".join(KERNELS),
                   help="comma-separated kernels to time (B1..B5)")
    p.add_argument("--sources", default="",
                   help="comma-separated NAME=DIR source trees to time as "
                        "variants (a csrc/ copy of another commit)")
    p.add_argument("--orders", default="rows",
                   help=f"comma-separated orders of the fused kernels' "
                        f"SYRK items to time ({', '.join(ORDERS)})")
    p.add_argument("--phases", default="bs128,bs16",
                   help="comma-separated phases: bs128 (f32; --f64 adds "
                        "f64), bs16 (f32 and f64), bs256 (f32; --f64 adds "
                        "f64)")
    p.add_argument("--f64", action="store_true",
                   help="also f64 at bs = 128 and the Dirichlet stage")
    p.add_argument("--dirichlet", action="store_true",
                   help="also the kernels at the feti-heat-3d Dirichlet "
                        "stage's shapes")
    args = p.parse_args(argv)
    levers = ["base"] + [v for v in args.levers.split(",")
                         if v and v != "base"]
    unknown = [v for v in levers if v not in LEVERS]
    if unknown:
        raise SystemExit(f"unknown levers {unknown}; known: {list(LEVERS)}")
    kernels = [k for k in KERNELS if k in args.kernels.split(",")]
    if not kernels:
        raise SystemExit(f"--kernels names none of {KERNELS}")
    orders = [o for o in args.orders.split(",") if o]
    if not orders or any(o not in ORDERS for o in orders):
        raise SystemExit(f"--orders {args.orders!r}: known {ORDERS}")
    phases = args.phases.split(",")

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_trsm_variants: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sources = dict(item.split("=", 1) for item in args.sources.split(",")
                   if item)
    dirs, regs = build(levers, {name: os.path.abspath(d)
                                for name, d in sources.items()},
                       sorted({KERNEL_LIBS[k] for k in kernels}))
    for key, (r, spill) in sorted(regs.items()):
        print(f"ptxas {key}: {r} registers, {spill} B spill stores")
    if "B3" in kernels:
        resident_clusters(dirs)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bad = []
    x = cs.kernel_inputs(dev)
    wide = (torch.float32, torch.float64) if args.f64 else (torch.float32,)
    if "bs128" in phases:
        bad += time_phase("bs128", x, wide, dirs, kernels, orders)
    if "bs256" in phases:
        x256 = cs.reblocked_inputs(x, dev, cs.WIDE_BS)
        bad += time_phase("bs256", x256, wide, dirs, kernels, orders)
        del x256
    if "bs16" in phases:
        x16 = cs.reblocked_inputs(x, dev, cs.SMALL_BS)
        del x
        bad += time_phase("bs16", x16, (torch.float32, torch.float64), dirs,
                          kernels, orders)
        del x16
    if args.dirichlet:
        gc.collect()
        torch.cuda.empty_cache()
        bad += time_phase("dirichlet", cs.dirichlet_inputs(dev), wide, dirs,
                          kernels, orders)
    if bad:
        print(f"variants that disagree with the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
