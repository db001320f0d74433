"""PCPG iteration counts of the Dirichlet and lumped preconditioners on 3-D
linear elasticity at feti-elasticity-3d's depth (2 x 2 x 2 subdomains),
the port's beside the reference's, over subdomain widths:

    PYTHONPATH=src python tests/elasticity_depth_sweep.py 2 4 6

prints one line per width: both packages' counts for each preconditioner
(explicit mode, tol 1e-9, bs = bm = 32, the port on the CPU through its
kernel path's plain versions). feti-elasticity-3d itself has 8^3 elements
per subdomain; chip_smoke.py gives its counts on the card.
``tests/test_torch_dirichlet.py`` runs the smallest width.
"""
from __future__ import annotations

import sys

DEPTH = (2, 2, 2)
PRECONDITIONERS = ("dirichlet", "lumped")


def iteration_counts(width: int, bs: int = 32, tol: float = 1e-9) -> dict:
    """{(package, preconditioner): iterations} on the (2,2,2) x
    (width,)*3 elasticity problem; each package decomposes it itself."""
    import jax
    import torch

    jax.config.update("jax_enable_x64", True)
    from repro.core import SchurAssemblyConfig as RefSchur
    from repro.fem import decompose_problem as ref_decompose
    from repro.feti import FetiConfig as RefFeti
    from repro.feti import FetiSolver as RefSolver

    from repro_torch.core import SchurAssemblyConfig
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, FetiSolver

    args = ("elasticity", 3, DEPTH, (width,) * 3)
    ref_prob, prob = ref_decompose(*args), decompose_problem(*args)
    counts = {}
    for pc in PRECONDITIONERS:
        ref = RefSolver(ref_prob, RefFeti(
            schur=RefSchur(block_size=bs, rhs_block_size=bs),
            mode="explicit", preconditioner=pc)).solve(tol=tol)
        port = FetiSolver(prob, FetiConfig(
            schur=SchurAssemblyConfig(block_size=bs, rhs_block_size=bs,
                                      use_kernels=True),
            mode="explicit", preconditioner=pc,
            device=torch.device("cpu"))).solve(tol=tol)
        assert ref.converged and port.converged, (width, pc)
        counts["reference", pc] = int(ref.iterations)
        counts["port", pc] = int(port.iterations)
    return counts


def main(argv) -> int:
    for width in (int(w) for w in argv or ["2"]):
        c = iteration_counts(width)
        n = 3 * (width + 1) ** 3
        print(f"elasticity 3-D {DEPTH} x ({width},)*3, {n} DOFs per "
              f"subdomain: dirichlet reference {c['reference', 'dirichlet']} "
              f"port {c['port', 'dirichlet']}; lumped reference "
              f"{c['reference', 'lumped']} port {c['port', 'lumped']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
