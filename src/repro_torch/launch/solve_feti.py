"""FETI solve launcher of the port:
``python -m repro_torch.launch.solve_feti --arch feti-heat-2d --kernels``.

Runs preprocess (factorization + sparsity-utilizing SC assembly) and the
PCPG solve for a registered FETI architecture on the card (``--device
cuda``, the default; it fails when CUDA is absent) or on the CPU
(``--device cpu``), reports stage timings, the iteration count and the
device bytes of the factor and operator stacks, and with ``--validate``
checks the solution against the undecomposed global sparse solve.

``--kernels`` sets ``SchurAssemblyConfig(use_kernels=True)``: the
architecture's TRSM/SYRK variants are replaced by the hand-written stepped
TRSM and SYRK kernels (their plain torch versions on the CPU), the port's
counterpart of the reference's Pallas pair (``use_pallas``). ``--fused``
assembles with the hand-written fused TRSM→SYRK kernel instead, as the
reference's ``--fused`` does with its Pallas one. ``--storage packed``
computes and keeps the factors in the packed fill-mask layout; with
``--kernels`` the TRSM is then the packed stepped TRSM kernel.

``--dtype f32`` or ``bf16`` stores the factor, F̃ and S_b stacks at that
dtype and computes them at f32 (the f32 kernels with ``--kernels`` or
``--fused``); ``--refine`` sets the
interior-solve refinement steps (default 2 below f64), which with
explicit mode also runs f64 defect-correction outers. The launcher prints
the storage, compute and solve dtypes, the outers taken and the stacks'
bytes.

``--n-rhs R`` solves R stacked load cases (the base load scaled by 1, 2,
…, R) through the multi-RHS block PCPG (``FetiSolver.solve_many``:
preprocess once, one block solve for the batch) instead of the single
load, and prints each column's iterations; with ``--validate`` every
column is checked against its own global solve, its error relative to that
solution's largest entry.

``--autotune`` replaces the architecture's hand-picked assembly config with
the joint planner of :mod:`repro_torch.core.stages` (``schur="auto"``: the
paper's Table-1 choice made per stage, the hand-written kernels among the
candidates timed on the card), prints each stage's plan, and checks the
autotuned F̃ against the dense baseline on the unpacked factor (exit 1
above 1e-8). Plans are cached under ``$REPRO_TORCH_PLAN_CACHE_DIR``
(default ``~/.cache/repro_torch/plans``); ``--no-plan-cache`` neither
reads nor writes it.

``--trace OUT.json`` records the per-iteration residual history and
exports the run's telemetry as a Chrome-trace JSON (``chrome://tracing`` /
Perfetto): the nested spans of every pipeline phase with the metrics
snapshot embedded (check it with ``python -m repro_torch.obs.validate
OUT.json``). ``--report`` prints :meth:`FetiSolver.report` (span tree,
metrics, device bytes) as JSON after the solve.

``--devices N`` splits the subdomains over N ranks
(:mod:`repro_torch.feti.sharded`, one process a rank started by
:func:`repro_torch.launch.mesh.spawn_ranks`): each rank preprocesses and
solves its own slice, the λ-space sums are all-reduces. The backend is
``nccl`` when each rank has a card of its own; ``--backend gloo`` lets
ranks share cards (or run on the CPU with ``--device cpu``), and without
it too few cards is an error. The kernels are built here before the ranks
start, so no two ranks run ``nvcc`` into one build directory. Each rank
prints one line: its subdomains, its kernel launches per kernel and dtype,
its preprocess and solve seconds, its peak device bytes and its
all-reduces (their count and seconds). With ``--validate`` the same solve
also runs on one device here, and the run fails when the sharded solution
is more than 1e-9 from it, takes another iteration count (one more or
fewer is allowed under ``--precond dirichlet``, as the reference allows),
or when the ranks' stack bytes do not sum to the single device's.
``--n-rhs`` composes with it. A rank that fails ends the run within the
collectives' timeout.

``--precond dirichlet`` assembles the primal boundary Schur complements
S_b = K_bb − K_bi K_ii⁻¹ K_ib as a second stage through the same config
(so the same kernels run it, on new shapes) and preconditions PCPG with
them. ``--problem {heat,elasticity}`` overrides the architecture's
workload; the ``feti-elasticity-{2d,3d}`` architectures default to
elasticity.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="feti-heat-2d")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--problem", choices=("heat", "elasticity"), default=None,
                   help="workload override: scalar heat (kernel dim 1) or "
                        "vector linear elasticity (rigid-body kernel dim "
                        "3/6); default: the architecture's own problem")
    p.add_argument("--mode", choices=("explicit", "implicit"),
                   default="explicit")
    p.add_argument("--precond", choices=("lumped", "dirichlet", "none"),
                   default="lumped",
                   help="PCPG preconditioner: lumped (B K Bᵀ), dirichlet "
                        "(B S_b Bᵀ with the primal boundary Schur "
                        "complement, assembled as a second stage), or none")
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--validate", action="store_true",
                   help="compare against the global sparse solve")
    p.add_argument("--autotune", action="store_true",
                   help="let the stage graph's joint planner pick every "
                        "assembly stage's config (schur='auto'); "
                        "--kernels and --fused are then ignored (the "
                        "planner enumerates both)")
    p.add_argument("--no-plan-cache", action="store_true",
                   help="neither read nor write the on-disk plan cache")
    p.add_argument("--kernels", action="store_true",
                   help="assemble with the hand-written stepped TRSM/SYRK "
                        "kernels (SchurAssemblyConfig.use_kernels)")
    p.add_argument("--fused", action="store_true",
                   help="assemble with the hand-written fused TRSM→SYRK "
                        "kernel (use_kernels=True, fused=True)")
    p.add_argument("--storage", choices=("dense", "packed"), default=None,
                   help="factor storage (default: the Schur config's, "
                        "dense)")
    p.add_argument("--dtype", choices=("f64", "f32", "bf16"), default="f64",
                   help="storage dtype of the device stacks: f64, f32 (half "
                        "the bytes; f64 accuracy recovered by iterative "
                        "refinement and defect-correction outers) or bf16 "
                        "(storage only: computed at f32)")
    p.add_argument("--refine", type=int, default=None, metavar="STEPS",
                   help="interior-solve refinement steps (default: 0 for "
                        "f64, 2 below; 0 disables refinement and solves at "
                        "the storage dtype)")
    p.add_argument("--n-rhs", type=int, default=0, metavar="R",
                   help="solve R stacked load cases (a load sweep) through "
                        "the multi-RHS block PCPG (solve_many) instead of "
                        "the single-load solve; with --validate each "
                        "column is checked against its own global solve")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="export the run's telemetry as a Chrome-trace JSON "
                        "(chrome://tracing / Perfetto): nested spans for "
                        "every pipeline phase plus the metrics snapshot; "
                        "implies per-iteration residual history")
    p.add_argument("--report", action="store_true",
                   help="print the structured telemetry report "
                        "(FetiSolver.report(): span tree, metrics, device "
                        "bytes) as JSON after the solve")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the stacks live and the work runs; cuda "
                        "fails when CUDA is not available")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="split the subdomains over N ranks (one process "
                        "each; torch.distributed), the λ-space sums as "
                        "all-reduces")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="the ranks' backend: nccl (default; a card a rank) "
                        "or gloo (ranks share cards round-robin, or run on "
                        "the CPU with --device cpu)")
    args = p.parse_args(argv)

    import numpy as np

    from repro_torch.configs import FetiArchConfig, get_config, get_smoke_config
    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.device import resolve_device
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, FetiSolver

    device = resolve_device(args.device)
    fc = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not isinstance(fc, FetiArchConfig):
        raise SystemExit(f"{args.arch} is not a FETI architecture")

    problem = args.problem or fc.problem
    prob = decompose_problem(problem, fc.dim, fc.sub_grid, fc.elems_per_sub)
    print(f"[feti] {fc.name}: problem={problem} "
          f"({prob.ndof_per_node} DOF/node, kernel dim {prob.kernel_dim}), "
          f"sub_grid={fc.sub_grid}, {prob.n_subdomains} subdomains x "
          f"{prob.subdomains[0].n} DOFs, {prob.n_lambda} multipliers, "
          f"m_max={prob.m_max}, device={device}")

    if args.autotune:
        cfg = "auto"
    elif args.fused:
        cfg = SchurAssemblyConfig(
            block_size=fc.block_size, rhs_block_size=fc.rhs_block_size,
            use_kernels=True, fused=True)
    else:
        cfg = SchurAssemblyConfig(
            trsm_variant=fc.trsm_variant, syrk_variant=fc.syrk_variant,
            block_size=fc.block_size, rhs_block_size=fc.rhs_block_size,
            use_kernels=args.kernels)
    config = FetiConfig(schur=cfg, mode=args.mode,
                        preconditioner=args.precond, storage=args.storage,
                        dtype=args.dtype, refine=args.refine, device=device,
                        plan_cache=not args.no_plan_cache)
    if args.devices:
        return _main_sharded(args, prob, config)
    solver = FetiSolver(prob, config)
    history = bool(args.trace)  # the trace embeds the convergence curve
    if args.n_rhs > 0:
        loads = prob.load_cases(args.n_rhs, kind="sweep")
        sol = solver.solve_many(loads, tol=args.tol, history=history)
    else:
        sol = solver.solve(tol=args.tol, history=history)

    if args.trace or args.report:
        import json

        rep = solver.report()
        if args.trace:
            solver.telemetry.tracer.to_chrome_trace(
                args.trace, metrics=rep["metrics"])
            print(f"[feti] telemetry trace -> {args.trace}")
        if args.report:
            print(json.dumps(rep, indent=1, default=float))

    st = solver.state
    cfg = solver.cfg  # the planner's choice under --autotune
    by = st.device_bytes()
    print(f"[feti] dtype: storage={sol.storage_dtype} "
          f"compute={sol.compute_dtype} solve={sol.solve_dtype} "
          f"refine={st.refine_steps} refine_outer={sol.refine_outer}")
    print(f"[feti] storage={st.storage} device bytes: L={by['L']:,} "
          f"K={by['K']:,} Btp={by['Btp']:,} F={by['F']:,} Kreg={by['Kreg']:,} "
          f"(dense L would be {by['dense_L']:,}) total={by['total']:,}")
    if st.Sb is not None:
        sp, env = st.split, st.dirichlet_env
        print(f"[feti] precond=dirichlet: boundary/interior split "
              f"{sp.n_b}/{sp.n_i} of {sp.n} DOFs, K_ib stripes start at "
              f"rows {env.col_starts.tolist()}, Sb={by['Sb']:,} "
              f"Btb={by['Btb']:,} bytes, shared_factor={st.shared_factor}")
        if st.dirichlet_plan is not None:
            for line in st.dirichlet_plan.summary().splitlines():
                print(f"[autotune:dirichlet] {line}")
    if solver.plan is not None:
        for line in solver.plan.summary().splitlines():
            print(f"[autotune] {line}")
        if st.F is not None:
            from repro_torch.core import schur_dense_baseline
            from repro_torch.sparse import PackedBlocks

            cd = config.compute_dtype
            L = st.L.unpack() if isinstance(st.L, PackedBlocks) else st.L
            F_ref = schur_dense_baseline(L.to(cd), st.Btp.to(cd))
            err = (st.F.to(cd) - F_ref).abs().max().item()
            print(f"[autotune] max |F_auto - F_dense_baseline| = {err:.2e}")
            if err > 1e-8:
                print("[autotune] FAIL: autotuned assembly disagrees with "
                      "the dense baseline")
                return 1
    if args.n_rhs > 0:
        converged = bool(sol.converged.all())
        iters = " ".join(str(int(i)) for i in sol.iterations)
        print(f"[feti] mode={args.mode} kernels={cfg.use_kernels} "
              f"fused={cfg.fused} n_rhs={sol.n_rhs} iters=[{iters}] "
              f"block_iters={sol.block_iterations} "
              f"residual={sol.residuals.max():.2e} converged={converged}")
        print(f"[feti] preprocess={sol.timings['preprocess_s']:.2f}s "
              f"solve_many={sol.timings['solve_many_s']:.2f}s "
              f"per_solve={sol.timings['per_solve_s'] * 1e3:.1f}ms")
        if args.validate:
            t0 = time.perf_counter()
            refs = prob.reference_solutions(loads)
            # each column against its own scale (a zero column against
            # the batch's)
            scale = np.abs(refs).max(axis=1)
            scale = np.where(scale > 0, scale, np.abs(refs).max())
            err = np.max(np.abs(sol.u_global - refs).max(axis=1) / scale)
            print(f"[feti] max per-column rel err vs global solves: "
                  f"{err:.2e} (the global solves took "
                  f"{time.perf_counter() - t0:.1f}s on the host)")
            if err > 1e-6:
                return 1
        return 0 if converged else 1
    print(f"[feti] mode={args.mode} kernels={cfg.use_kernels} fused={cfg.fused} "
          f"iters={sol.iterations} residual={sol.residual:.2e} "
          f"converged={sol.converged}")
    print(f"[feti] preprocess={sol.timings['preprocess_s']:.2f}s "
          f"solve={sol.timings['solve_s']:.2f}s")

    if args.validate:
        t0 = time.perf_counter()
        u_ref = prob.reference_solution()
        err = np.max(np.abs(sol.u_global - u_ref)) / np.abs(u_ref).max()
        print(f"[feti] rel err vs global solve: {err:.2e} (the global "
              f"solve took {time.perf_counter() - t0:.1f}s on the host)")
        if err > 1e-6:
            return 1
    return 0 if sol.converged else 1


def _main_sharded(args, prob, config) -> int:
    """``--devices N``: the solve on N ranks, one line a rank, and with
    ``--validate`` the checks against the global solve and against the
    same solve on one device."""
    import json

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.feti import FetiSolver, sharded
    from repro_torch.launch import mesh as meshlib

    if args.trace or args.report:
        raise SystemExit("--trace and --report read one process's "
                         "telemetry; with --devices each rank keeps its own")
    try:
        backend, devices = meshlib.rank_devices(args.devices, args.backend,
                                                config.device)
    except ValueError as e:
        raise SystemExit(f"[feti] --devices {args.devices}: {e}") from None
    print(f"[feti] mesh: {meshlib.describe(backend, devices)}; "
          f"{args.devices} slice(s) of "
          f"{meshlib.split_sizes(prob.n_subdomains, args.devices)} "
          f"subdomains", flush=True)
    if config.device.type == "cuda":
        from repro_torch.kernels import build

        secs = build.build()
        print(f"[feti] kernels built before the ranks start: "
              f"{sorted(secs) or 'all cached'}", flush=True)
    sweep = args.n_rhs > 0
    case = dict(arch=args.arch, smoke=args.smoke, problem=args.problem,
                n_rhs=args.n_rhs, tol=args.tol,
                config=dict(schur=config.schur, mode=config.mode,
                            preconditioner=config.preconditioner,
                            storage=config.storage, dtype=config.dtype,
                            refine=config.refine,
                            plan_cache=config.plan_cache))
    try:
        ranks = [r[0] for r in meshlib.spawn_ranks(
            sharded.solve_cases, args.devices, backend=backend,
            device=config.device, args=([case],))]
    except meshlib.RankFailure as e:
        print(f"[feti] FAIL: {e}", flush=True)
        return 1
    for r in ranks:
        sol = r["solution"]
        line = dict(subdomains=list(r["owned"]), device=r["device"],
                    launches=r["launches"], preprocess_s=r["preprocess_s"],
                    solve_s=r["solve_s"],
                    peak_device_bytes=r["peak_device_bytes"],
                    all_reduces=r["all_reduces"],
                    all_reduce_s=r["all_reduce_s"],
                    pcpg_all_reduces=r["pcpg_all_reduces"],
                    iterations=np.asarray(sol.iterations).tolist(),
                    device_bytes=r["device_bytes"])
        print(f"[feti] rank {r['rank']}/{r['world_size']} "
              f"{json.dumps(line)}", flush=True)
    sol = ranks[0]["solution"]
    same = all(np.array_equal(r["solution"].u_global, sol.u_global)
               and np.array_equal(r["solution"].iterations, sol.iterations)
               for r in ranks)
    print(f"[feti] every rank returned the same solution: {same}")
    if not same:
        return 1
    by = {k: sum(r["device_bytes"][k] for r in ranks)
          for k in ("L", "K", "Btp", "F", "Kreg", "Sb", "Btb", "total",
                    "dense_L")}
    print(f"[feti] dtype: storage={sol.storage_dtype} "
          f"compute={sol.compute_dtype} solve={sol.solve_dtype} "
          f"refine={config.resolved_refine()} "
          f"refine_outer={sol.refine_outer}")
    print(f"[feti] ranks' device bytes summed: L={by['L']:,} K={by['K']:,} "
          f"Btp={by['Btp']:,} F={by['F']:,} Kreg={by['Kreg']:,} "
          f"(dense L would be {by['dense_L']:,}) total={by['total']:,}")
    if ranks[0]["plans"] is not None:
        same_plan = all(r["plans"] == ranks[0]["plans"] for r in ranks)
        for stage, c in ranks[0]["plans"].items():
            print(f"[autotune] [{stage}] {c}")
        print(f"[autotune] every rank runs rank 0's plan: {same_plan}")
        if not same_plan:
            return 1
    prep = max(r["preprocess_s"] for r in ranks)
    solve = max(r["solve_s"] for r in ranks)
    if sweep:
        converged = bool(sol.converged.all())
        iters = " ".join(str(int(i)) for i in sol.iterations)
        print(f"[feti] mode={args.mode} n_rhs={sol.n_rhs} iters=[{iters}] "
              f"block_iters={sol.block_iterations} "
              f"residual={sol.residuals.max():.2e} converged={converged}")
        print(f"[feti] preprocess={prep:.2f}s solve_many={solve:.2f}s "
              f"(the slowest rank's)")
    else:
        converged = bool(sol.converged)
        print(f"[feti] mode={args.mode} iters={sol.iterations} "
              f"residual={sol.residual:.2e} converged={converged}")
        print(f"[feti] preprocess={prep:.2f}s solve={solve:.2f}s (the "
              f"slowest rank's)")
    if not args.validate:
        return 0 if converged else 1

    if sweep:
        loads = prob.load_cases(args.n_rhs, kind="sweep")
        refs = prob.reference_solutions(loads)
        scale = np.abs(refs).max(axis=1)
        scale = np.where(scale > 0, scale, np.abs(refs).max())
        err = np.max(np.abs(sol.u_global - refs).max(axis=1) / scale)
        print(f"[feti] max per-column rel err vs global solves: {err:.2e}")
    else:
        u_ref = prob.reference_solution()
        err = np.max(np.abs(sol.u_global - u_ref)) / np.abs(u_ref).max()
        print(f"[feti] rel err vs global solve: {err:.2e}")
    if err > 1e-6:
        return 1
    # the same solve on one device, here
    if config.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(config.device)
    kernels.reset_launch_counts()
    single = FetiSolver(prob, config)
    one = (single.solve_many(loads, tol=args.tol) if sweep
           else single.solve(tol=args.tol))
    du = float(np.max(np.abs(sol.u_global - one.u_global)))
    slack = 1 if args.precond == "dirichlet" else 0
    d_it = np.max(np.abs(np.asarray(sol.iterations)
                         - np.asarray(one.iterations)))
    peak = (torch.cuda.max_memory_allocated(config.device)
            if config.device.type == "cuda" else None)
    print(f"[feti] sharded vs single-device: max|Δu|={du:.2e} iters "
          f"{np.asarray(sol.iterations).tolist()} vs "
          f"{np.asarray(one.iterations).tolist()}")
    print(f"[feti] single-device run: preprocess="
          f"{one.timings['preprocess_s']:.2f}s solve="
          f"{one.timings['solve_many_s' if sweep else 'solve_s']:.2f}s "
          f"peak_device_bytes={peak}")
    one_by = single.state.device_bytes()
    sums = {k: (by[k], one_by[k]) for k in ("L", "K", "Btp", "F", "Kreg",
                                            "Sb", "Btb")}
    bytes_ok = all(a == b for a, b in sums.values())
    print(f"[feti] ranks' stack bytes sum to the single device's: "
          f"{bytes_ok} {json.dumps(sums)}; single-device launches "
          f"{kernels.launch_counts()}")
    if du > 1e-9 or d_it > slack or not bytes_ok:
        print("[feti] FAIL: the sharded solve diverged from the "
              "single-device solve")
        return 1
    return 0 if converged else 1


if __name__ == "__main__":
    sys.exit(main())
