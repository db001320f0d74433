"""Time variants of the stepped-TRSM device code side by side on the card.

    python3 tests/torch_trsm_variants.py [--levers row_ring3,panel_kc32,...]
        [--dirichlet]

Each lever is a set of substitutions in the sources of
``src/repro_torch/kernels/csrc`` (a constant or a launch bound; LEVERS
lists them). The script copies the sources once per lever into
``build/trsm_variants/<lever>/``, applies the substitutions (a text that
is not found stops it), builds every variant's TRSM and fused libraries at
once through ``repro_torch.kernels.build`` and prints each instance's
registers and spills. Then, on feti-heat-2d's full-size factor
(``chip_smoke.kernel_inputs``) at bs = 128 (f32) and at bs = bm = 16
(``chip_smoke.small_block_inputs``; f32 and f64), it runs the stepped TRSM,
the packed one and both fused kernels of every variant ("base": the
sources as they are) through the port's own wrappers inside
``build.sources(<the variant's copy>)``, holds each against its plain
version (chip_smoke's F32_TOL and REL_TOL) and prints its CUDA-event median
time; an f32 TRSM's distance from the f64 kernel on the same operands is
printed beside chip_smoke's F32_TRSM_TWIN_TOL. ``--dirichlet`` adds the f32
kernels on the full-size feti-heat-3d Dirichlet stage's operands
(``chip_smoke.dirichlet_inputs``, ~17 GB of host memory). Compare variants
only within one run. Needs one card and nvcc.
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
LIBS = ("stepped_trsm", "stepped_trsm_syrk")

# lever: [(text in the sources, its replacement), ...]
ROW_KC = "constexpr int ROW_KC = sizeof(T) == 8 ? 16 : 32;"
ROW_STAGES = "constexpr int ROW_STAGES = sizeof(T) == 8 ? 3 : 2;"
PKC = "constexpr int PKC = sizeof(T) == 8 ? 32 : 64;"
K8_LOOP = """  static_assert(MI % 2 == 0 && KDEPTH % 8 == 0, "m16n8k8 tiles");
#pragma unroll 1
  for (int k = 0; k < KDEPTH; k += 8) {
    uint32_t a_hi"""
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
    # the 3xTF32 product's k8 steps unrolled
    "k_unroll": [(K8_LOOP, K8_LOOP.replace("#pragma unroll 1",
                                           "#pragma unroll"))],
    # launch bounds asking for three blocks a SM (every instance)
    "bound3": [("__launch_bounds__(THREADS)",
                "__launch_bounds__(THREADS, 3)")],
    # the panel and k-split cores' rings 2 deep
    "small_ring2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
}


def build(levers):
    """The sources of each lever (``build/trsm_variants/<lever>``; "base"
    the port's own), their libraries built all at once; returns
    ({lever: source directory}, {(lever, kernel, dtype, chunk, factor):
    (registers, spill bytes)})."""
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
    with ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: kbuild.build(LIBS, csrc=d), dirs.values()))
    regs = {}
    for lever, d in dirs.items():
        for lib in LIBS:
            log = kbuild._library_path(lib, d).with_suffix(".log").read_text()
            for block in re.split(r"Compiling entry function", log)[1:]:
                name = block.split("'")[1]
                m = re.search(
                    r"(\w+_kernel)I([fd])Li(\d+)EN7stepped\d+(\w+?)I", name)
                used = re.search(r"Used (\d+) registers", block)
                spills = re.findall(r"(\d+) bytes spill stores", block)
                if m and used:
                    regs[(lever, m.group(1), m.group(2), int(m.group(3)),
                          m.group(4))] = (int(used.group(1)),
                                          sum(int(b) for b in spills))
    return dirs, regs


def time_phase(label, xx, dtypes, dirs):
    """Each lever's four kernels on one phase's operands ``xx``, launched
    through the port's wrappers from the lever's sources, checked against
    their plain versions and timed; returns the disagreements."""
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
        order, porder = xx["orders"]
        plain = {
            "B1": K.stepped_trsm_plain(*dense, B, starts, bs, bm),
            "B3": K.stepped_trsm_packed_plain(*packed, B, starts, bs, bm),
            "B4": K.stepped_trsm_syrk_plain(*dense, B, starts, bs, bm),
            "B5": K.stepped_trsm_syrk_packed_plain(*packed, B, starts, bs,
                                                   bm)}

        def wide(operands):  # the same values at f64
            return [a.double() if a.is_floating_point() else a
                    for a in operands]

        # the f32 TRSM's yardstick: the port's f64 kernel on the same values
        twin = (K.stepped_trsm_kernel(*wide(dense), B.double(), starts, bs,
                                      bm) if suf == "f32" else None)
        runs = {
            "B1": lambda: K.stepped_trsm_kernel(*dense, B, starts, bs, bm),
            "B3": lambda: K.stepped_trsm_packed_kernel(*packed, B, starts,
                                                       bs, bm),
            "B4": lambda: K.stepped_trsm_syrk_kernel(*dense, B, starts, bs,
                                                     bm, order=order),
            "B5": lambda: K.stepped_trsm_syrk_packed_kernel(
                *packed, B, starts, bs, bm, order=porder)}
        for v, d in dirs.items():
            cells = []
            with kbuild.sources(d):
                for name, run in runs.items():
                    got = run()
                    torch.cuda.synchronize()
                    err = cs.compare(got, plain[name])[1]
                    if not err <= tol:
                        bad.append((label, suf, v, name, err))
                    cell = f"{name} {cs.cuda_ms(run):.3f} ms (rel {err:.1e}"
                    if twin is not None and name in ("B1", "B3"):
                        terr = cs.compare(got.double(), twin)[1]
                        cell += (f", {terr:.1e} from f64"
                                 + (" > F32_TRSM_TWIN_TOL"
                                    if terr > cs.F32_TRSM_TWIN_TOL else ""))
                    cells.append(cell + ")")
            print(f"{label} {suf} {v}: " + "; ".join(cells), flush=True)
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--levers", default=",".join(LEVERS),
                   help="comma-separated LEVERS keys (base is always run)")
    p.add_argument("--dirichlet", action="store_true",
                   help="also the f32 kernels at the feti-heat-3d Dirichlet "
                        "stage's shapes")
    args = p.parse_args(argv)
    levers = ["base"] + [v for v in args.levers.split(",")
                         if v and v != "base"]
    unknown = [v for v in levers if v not in LEVERS]
    if unknown:
        raise SystemExit(f"unknown levers {unknown}; known: {list(LEVERS)}")

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
    dirs, regs = build(levers)
    for key, (r, spill) in sorted(regs.items()):
        print(f"ptxas {key}: {r} registers, {spill} B spill stores")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bad = []
    x = cs.kernel_inputs(dev)
    x16 = cs.small_block_inputs(x, dev)
    bad += time_phase("bs128", x, (torch.float32,), dirs)
    del x
    bad += time_phase("bs16", x16, (torch.float32, torch.float64), dirs)
    del x16
    if args.dirichlet:
        gc.collect()
        torch.cuda.empty_cache()
        bad += time_phase("dirichlet", cs.dirichlet_inputs(dev),
                          (torch.float32,), dirs)
    if bad:
        print(f"variants that disagree with the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
