"""FETI solve launcher of the port:
``python -m repro_torch.launch.solve_feti --arch feti-heat-2d --kernels``.

Runs preprocess (factorization + sparsity-utilizing SC assembly) and the
PCPG solve for a registered FETI architecture on the card (``--device
cuda``, the default; it fails when CUDA is absent) or on the CPU
(``--device cpu``), reports stage timings and the iteration count, and
with ``--validate`` checks the solution against the undecomposed global
sparse solve.

``--kernels`` sets ``SchurAssemblyConfig(use_kernels=True)``: the
architecture's TRSM/SYRK variants are replaced by the hand-written stepped
TRSM and SYRK kernels (their plain torch versions on the CPU). It is the
port's way to the reference's Pallas pair; the reference reaches its
kernels through ``--fused``, whose fused kernel is ROADMAP item B4.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="feti-heat-2d")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--mode", choices=("explicit", "implicit"),
                   default="explicit")
    p.add_argument("--precond", choices=("lumped", "none"), default="lumped",
                   help="PCPG preconditioner: lumped (B K Bᵀ) or none; "
                        "dirichlet is ROADMAP item A11")
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--validate", action="store_true",
                   help="compare against the global sparse solve")
    p.add_argument("--kernels", action="store_true",
                   help="assemble with the hand-written stepped TRSM/SYRK "
                        "kernels (SchurAssemblyConfig.use_kernels)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the stacks live and the work runs; cuda "
                        "fails when CUDA is not available")
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

    prob = decompose_problem(fc.problem, fc.dim, fc.sub_grid, fc.elems_per_sub)
    print(f"[feti] {fc.name}: problem={fc.problem}, {prob.n_subdomains} "
          f"subdomains x {prob.subdomains[0].n} DOFs, {prob.n_lambda} "
          f"multipliers, m_max={prob.m_max}, device={device}")

    cfg = SchurAssemblyConfig(
        trsm_variant=fc.trsm_variant, syrk_variant=fc.syrk_variant,
        block_size=fc.block_size, rhs_block_size=fc.rhs_block_size,
        use_kernels=args.kernels,
    )
    config = FetiConfig(schur=cfg, mode=args.mode,
                        preconditioner=args.precond, device=device)
    solver = FetiSolver(prob, config)
    sol = solver.solve(tol=args.tol)

    by = solver.state.device_bytes()
    print(f"[feti] device bytes: L={by['L']:,} K={by['K']:,} "
          f"Btp={by['Btp']:,} F={by['F']:,}")
    print(f"[feti] mode={args.mode} kernels={args.kernels} "
          f"iters={sol.iterations} residual={sol.residual:.2e} "
          f"converged={sol.converged}")
    print(f"[feti] preprocess={sol.timings['preprocess_s']:.2f}s "
          f"solve={sol.timings['solve_s']:.2f}s")

    if args.validate:
        u_ref = prob.reference_solution()
        err = np.max(np.abs(sol.u_global - u_ref)) / np.abs(u_ref).max()
        print(f"[feti] rel err vs global solve: {err:.2e}")
        if err > 1e-6:
            return 1
    return 0 if sol.converged else 1


if __name__ == "__main__":
    sys.exit(main())
