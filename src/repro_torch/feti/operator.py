"""The FETI dual operator F = B K⁺ Bᵀ and friends, batched over subdomains
(counterpart of ``repro.feti.operator``; dense or packed factors; f64 or
reduced-precision stacks with iterative refinement).

Every operator is rank-generic over a trailing column axis: an
(n_lambda,) dual vector goes through per-subdomain GEMVs, an
(n_lambda, n_rhs) stack of them (the reference's ``*_many`` operators)
through GEMMs that read each stored stack once for all columns.

Implicit application (paper eq. 11): SPMV + two TRSV + SPMV per subdomain.
Explicit application (paper eq. 12): one dense GEMV per subdomain against
the preassembled SC.

The gather (λ → local) / scatter-add (local → λ) pair is the algebraic form
of the paper's neighbour exchange. The reference scatters with
``out.at[ids].add``; an ``index_add_`` on the card would sum with atomics
in an order that changes from run to run (and can flip PCPG iteration
counts). Every multiplier has at most two local copies, so the port
precomputes both copies' slots once (:class:`DualMap`) and the scatter is
a gather and one add — deterministic, and the same sum as the reference's.

On one rank's slice of the subdomains (:mod:`repro_torch.feti.sharded`)
the map is built with ``sliced=True``: a multiplier with no copy on the
slice, or one of its two, points the missing slots at the zero slot. Each
rank's scatter then holds, for every multiplier, at most its two copies
and exact zeros, so the all-reduced sum over the ranks is the two-copy sum
``x₁ + x₂`` whatever order the ranks are added in: the sharded dual apply,
preconditioners and right-hand side are bit-identical to the single-device
ones wherever the per-subdomain products are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.precision import compute_dtype
from repro_torch.sparse.packed import (
    PackedBlocks,
    packed_symm_matvec,
    packed_tri_solve,
)

__all__ = [
    "DualMap",
    "dual_map",
    "batched_apply",
    "gather_local",
    "scatter_dual",
    "local_dual_apply",
    "explicit_dual_apply",
    "implicit_dual_apply",
    "lumped_preconditioner",
    "dirichlet_preconditioner",
    "dual_rhs",
    "dual_load",
    "solve_with_factor",
    "apply_stiffness",
    "solve_with_factor_refined",
    "implicit_dual_apply_refined",
    "dual_rhs_refined",
    "dual_load_refined",
]


@dataclasses.dataclass(frozen=True)
class DualMap:
    """Where each multiplier's local copies live in the (S, m_max) stacks.

    ``first``/``second`` index the flattened (S·m_max) local stack with one
    zero slot appended (index S·m_max); multipliers with a single copy
    point ``second`` at that zero slot.
    """

    lambda_ids: torch.Tensor  # (S, m_max) int64 global ids; pad = n_lambda
    first: torch.Tensor  # (n_lambda,) int64
    second: torch.Tensor  # (n_lambda,) int64
    n_lambda: int


def dual_map(lambda_ids: np.ndarray, n_lambda: int,
             device: torch.device, sliced: bool = False) -> DualMap:
    """Build the :class:`DualMap` of an (S, m_max) multiplier-id stack.

    Copies are taken in flat (subdomain-major) order, the order the
    reference's scatter-add visits them. Raises ``ValueError`` if a
    multiplier has more than two copies, or none unless ``sliced``: the
    stack is then one rank's slice of the subdomains, and a multiplier
    without a copy there reads the zero slot twice.
    """
    ids = np.asarray(lambda_ids, dtype=np.int64)
    flat = ids.reshape(-1)
    zero_slot = flat.size
    real = np.flatnonzero(flat < n_lambda)
    # the copies by multiplier, then the zero slot (where a multiplier
    # without a copy past the last one would start)
    order = np.append(real[np.argsort(flat[real], kind="stable")], zero_slot)
    counts = np.bincount(flat[real], minlength=n_lambda)
    if counts.max(initial=0) > 2 or (
            not sliced and counts.min(initial=1) < 1):
        raise ValueError("every multiplier needs one or two local copies")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    first = np.where(counts >= 1, order[starts], zero_slot)
    second = np.where(counts == 2, order[np.minimum(starts + 1, len(order) - 1)],
                      zero_slot)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
    return DualMap(lambda_ids=as_t(ids), first=as_t(first),
                   second=as_t(second), n_lambda=int(n_lambda))


def gather_local(lam: torch.Tensor, dm: DualMap) -> torch.Tensor:
    """(n_lambda,) dual vector -> (S, m_max) local blocks (pad id reads 0).
    Rank-generic: an (n_lambda, n_rhs) stack gathers to (S, m_max, n_rhs)."""
    lam_ext = torch.cat([lam, lam.new_zeros((1,) + lam.shape[1:])])
    return lam_ext[dm.lambda_ids]


def scatter_dual(vals: torch.Tensor, dm: DualMap) -> torch.Tensor:
    """(S, m_max) local blocks -> (n_lambda,) additive dual assembly.
    Rank-generic: (S, m_max, n_rhs) scatters to (n_lambda, n_rhs), each
    column by the same two-copy gather."""
    cols = vals.shape[2:]
    flat = torch.cat([vals.reshape((-1,) + cols), vals.new_zeros((1,) + cols)])
    return flat[dm.first] + flat[dm.second]


def local_dual_apply(apply_local, dm: DualMap, lam: torch.Tensor
                     ) -> torch.Tensor:
    """gather(λ) → per-subdomain local apply → scatter-add back into λ."""
    return scatter_dual(apply_local(gather_local(lam, dm)), dm)


def batched_apply(A: torch.Tensor, x: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """Batched ``A_s x_s`` (``A_sᵀ x_s`` with ``transpose``): (S, a, b) on
    an (S, b) vector stack, one GEMV per subdomain, or on an (S, b, n_rhs)
    column block, one GEMM."""
    A = A.mT if transpose else A
    if x.dim() == 2:
        return (A @ x.unsqueeze(-1)).squeeze(-1)
    return A @ x


def _minus_c(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q − c, ``c`` (n_lambda,) broadcast over q's columns."""
    return q - (c if q.dim() == 1 else c[:, None])


def explicit_dual_apply(F: torch.Tensor, dm: DualMap, lam: torch.Tensor
                        ) -> torch.Tensor:
    """q = Σᵢ B̃ᵢᵀ-scatter( F̃ᵢ · gather(λ) )   (paper eq. 12)."""
    return local_dual_apply(lambda p: batched_apply(F, p), dm, lam)


def _factor_dtype(L) -> torch.dtype:
    return L.values.dtype if isinstance(L, PackedBlocks) else L.dtype


def solve_with_factor(L, b: torch.Tensor) -> torch.Tensor:
    """Apply (L Lᵀ)⁻¹ to a subdomain-stacked (S, n) right-hand side or an
    (S, n, n_rhs) column block of them.

    The one forward/backward triangular-solve pair every consumer of the
    factor shares (implicit dual operator, dual RHS, solution recovery).
    ``L`` is a dense (S, n, n) stack or a packed
    :class:`~repro_torch.sparse.packed.PackedBlocks` stack, of ``b``'s
    dtype. A bf16 factor (storage only: torch has no bf16 triangular solve)
    is solved at f32 from a transient f32 copy, and the result is rounded
    back to bf16.
    """
    fd = _factor_dtype(L)
    if b.dtype != fd:
        raise TypeError(f"solve_with_factor: the right-hand side is "
                        f"{b.dtype}, the factor {fd}; cast explicitly")
    cd = compute_dtype(fd)
    if cd != fd:
        return solve_with_factor(L.to(cd), b.to(cd)).to(fd)
    if isinstance(L, PackedBlocks):
        return packed_tri_solve(L, packed_tri_solve(L, b), transpose=True)
    x = b.unsqueeze(-1) if b.dim() == 2 else b
    t = torch.linalg.solve_triangular(L, x, upper=False)
    x = torch.linalg.solve_triangular(L.mT, t, upper=True)
    return x.squeeze(-1) if b.dim() == 2 else x


def apply_stiffness(K, v: torch.Tensor) -> torch.Tensor:
    """Batched ``Kᵢ vᵢ`` for a stiffness stack stored dense or packed."""
    if isinstance(K, PackedBlocks):
        return packed_symm_matvec(K, v)
    return batched_apply(K, v)


def implicit_dual_apply(L, Btp: torch.Tensor, dm: DualMap,
                        lam: torch.Tensor) -> torch.Tensor:
    """q = Σᵢ scatter( B̃ᵢ L⁻ᵀL⁻¹ B̃ᵢᵀ gather(λ) )  (paper eq. 11)."""
    return local_dual_apply(
        lambda p: batched_apply(
            Btp, solve_with_factor(L, batched_apply(Btp, p)), transpose=True),
        dm, lam)


def lumped_preconditioner(K, Bt: torch.Tensor, dm: DualMap, w: torch.Tensor
                          ) -> torch.Tensor:
    """Lumped FETI preconditioner: M⁻¹ ≈ Σᵢ B̃ᵢ Kᵢ B̃ᵢᵀ.

    ``K`` is the unregularized stiffness stack — dense, or packed in the
    factor's block layout (what the preprocessor keeps); ``Bt`` shares K's
    row order.
    """
    return local_dual_apply(
        lambda p: batched_apply(Bt, apply_stiffness(K, batched_apply(Bt, p)),
                                transpose=True), dm, w)


def dirichlet_preconditioner(Sb: torch.Tensor, Btb: torch.Tensor,
                             dm: DualMap, w: torch.Tensor) -> torch.Tensor:
    """Dirichlet FETI preconditioner: M⁻¹ = Σᵢ B̃ᵢ S_b,i B̃ᵢᵀ with the
    primal boundary Schur complement S_b = K_bb − K_bi K_ii⁻¹ K_ib
    (:mod:`repro_torch.feti.dirichlet`).

    ``Sb`` is the dense (S, n_b, n_b) stack, ``Btb`` the boundary-row slice
    of B̃ᵀ, (S, n_b, m_max): B̃ᵀ has no interior rows by construction of
    the split, so the restriction loses nothing.
    """
    return local_dual_apply(
        lambda p: batched_apply(Btb, batched_apply(Sb, batched_apply(Btb, p)),
                                transpose=True), dm, w)


def dual_load(L, Btp: torch.Tensor, fp: torch.Tensor,
              dm: DualMap) -> torch.Tensor:
    """B K⁺ f, the load half of :func:`dual_rhs` (one rank's partial sum
    on a slice)."""
    t = solve_with_factor(L, fp)
    return scatter_dual(batched_apply(Btp, t, transpose=True), dm)


def dual_rhs(L, Btp: torch.Tensor, fp: torch.Tensor,
             dm: DualMap, c: torch.Tensor) -> torch.Tensor:
    """d = B K⁺ f − c (paper §2.1); an (S, n, n_rhs) load stack ``fp``
    gives D = B K⁺ F − c1ᵀ."""
    return _minus_c(dual_load(L, Btp, fp, dm), c)


# iterative refinement around reduced-precision factors: the factor stacks
# (and F̃) stay at the storage dtype, but the solve needs f64-accurate
# interior solves. Solve at the factor's dtype, take the true residual
# against the f64 regularized stiffness K_reg (the matrix the factor
# approximates; packed, applied by the deterministic gather of
# packed_symm_matvec), correct; each step contracts the error by about
# kappa(K_reg) eps. torch does not promote mixed dtypes as jnp does, so every
# crossing between the f64 vectors and a reduced stack is an explicit cast.

def solve_with_factor_refined(L, Kreg: PackedBlocks, b: torch.Tensor,
                              steps: int) -> torch.Tensor:
    """f64-accurate K_reg⁻¹ b through a reduced-precision factor ``L`` of
    K_reg, by ``steps`` rounds of iterative refinement. ``Kreg`` is the f64
    regularized stiffness stack in factor row order (packed); ``b``, the
    result and the residuals carry the solve dtype (f64)."""
    fd = _factor_dtype(L)
    x = solve_with_factor(L, b.to(fd)).to(b.dtype)
    for _ in range(steps):
        r = b - apply_stiffness(Kreg, x)
        x = x + solve_with_factor(L, r.to(fd)).to(b.dtype)
    return x


def implicit_dual_apply_refined(L, Kreg: PackedBlocks, Bt: torch.Tensor,
                                dm: DualMap, steps: int, lam: torch.Tensor
                                ) -> torch.Tensor:
    """Eq. 11 with a refined interior solve: an f64-accurate F application
    through a reduced-precision factor. ``Bt`` is B̃ᵀ (factor row order) at
    λ's dtype: B̃ᵀ holds exact ±1/0 entries, so the caller casts the stored
    stack once, exactly."""
    return local_dual_apply(
        lambda p: batched_apply(Bt, solve_with_factor_refined(
            L, Kreg, batched_apply(Bt, p), steps), transpose=True), dm, lam)


def dual_load_refined(L, Kreg: PackedBlocks, Bt: torch.Tensor,
                      fp: torch.Tensor, dm: DualMap, steps: int
                      ) -> torch.Tensor:
    """B K⁺ f with the refined interior solve, the load half of
    :func:`dual_rhs_refined`."""
    t = solve_with_factor_refined(L, Kreg, fp, steps)
    return scatter_dual(batched_apply(Bt, t, transpose=True), dm)


def dual_rhs_refined(L, Kreg: PackedBlocks, Bt: torch.Tensor,
                     fp: torch.Tensor, dm: DualMap, steps: int,
                     c: torch.Tensor) -> torch.Tensor:
    """d = B K⁺ f − c with the refined (f64-accurate) interior solve; ``Bt``
    at ``fp``'s dtype, as in :func:`implicit_dual_apply_refined`."""
    return _minus_c(dual_load_refined(L, Kreg, Bt, fp, dm, steps), c)
