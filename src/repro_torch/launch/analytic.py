"""Exact analytic FLOP / byte counts of the FETI solve phase (the FETI part
of the framework-free ``repro.launch.analytic``; its LM cells are ROADMAP
item A18).

``FetiSolver.amortization_report`` attaches :func:`feti_solve_iter_counts`
per ``n_rhs``, so the reference's and the port's reports agree by
construction.
"""
from __future__ import annotations

__all__ = ["feti_solve_iter_counts", "FETI_SOLVE_N_RHS"]

# default multi-RHS width of the reference's ``solve_iter_multi`` dry-run
# cell (the middle of its n_rhs sweep 1, 4, 16, 64)
FETI_SOLVE_N_RHS = 16


def feti_solve_iter_counts(S: int, m: int, n_rhs: int = 1,
                           fb: int = 4) -> dict:
    """Executed flops / device bytes of ONE explicit dual-operator
    application (paper eq. 12) on an (n_lambda, n_rhs) multiplier stack.

    Flops: one (m×m)·(m×n_rhs) GEMM per subdomain = ``2·S·m²·n_rhs`` —
    linear in n_rhs. Bytes: the (S, m, m) SC stack streams from memory
    ONCE per block application regardless of n_rhs (that is the whole
    multi-RHS amortization), plus the in/out multiplier stacks — so
    arithmetic intensity grows ≈linearly with n_rhs until the GEMM turns
    compute-bound. ``fb`` is the stack's bytes an element.
    """
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    flops = 2.0 * S * m * m * n_rhs
    bytes_ = float(S * (m * m + 2 * m * n_rhs) * fb)
    return {
        "flops": float(flops),
        "bytes": bytes_,
        "flops_per_rhs": float(flops / n_rhs),
        "bytes_per_rhs": bytes_ / n_rhs,
        "arithmetic_intensity": flops / bytes_,
        "n_rhs": int(n_rhs),
    }
