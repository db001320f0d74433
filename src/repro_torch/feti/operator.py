"""The FETI dual operator F = B K⁺ Bᵀ and friends, batched over subdomains
(counterpart of ``repro.feti.operator``, single right-hand side, dense
factors).

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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.packed import PackedBlocks, packed_symm_matvec

__all__ = [
    "DualMap",
    "dual_map",
    "gather_local",
    "scatter_dual",
    "local_dual_apply",
    "explicit_dual_apply",
    "implicit_dual_apply",
    "lumped_preconditioner",
    "dual_rhs",
    "solve_with_factor",
    "apply_stiffness",
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
             device: torch.device) -> DualMap:
    """Build the :class:`DualMap` of an (S, m_max) multiplier-id stack.

    Copies are taken in flat (subdomain-major) order, the order the
    reference's scatter-add visits them. Raises ``ValueError`` if a
    multiplier has no copy or more than two.
    """
    ids = np.asarray(lambda_ids, dtype=np.int64)
    flat = ids.reshape(-1)
    zero_slot = flat.size
    real = np.flatnonzero(flat < n_lambda)
    order = real[np.argsort(flat[real], kind="stable")]
    counts = np.bincount(flat[real], minlength=n_lambda)
    if counts.min(initial=1) < 1 or counts.max(initial=0) > 2:
        raise ValueError("every multiplier needs one or two local copies")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    first = order[starts]
    second = np.where(counts == 2, order[np.minimum(starts + 1, len(order) - 1)],
                      zero_slot)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
    return DualMap(lambda_ids=as_t(ids), first=as_t(first),
                   second=as_t(second), n_lambda=int(n_lambda))


def gather_local(lam: torch.Tensor, dm: DualMap) -> torch.Tensor:
    """(n_lambda,) dual vector -> (S, m_max) local blocks (pad id reads 0)."""
    lam_ext = torch.cat([lam, lam.new_zeros(1)])
    return lam_ext[dm.lambda_ids]


def scatter_dual(vals: torch.Tensor, dm: DualMap) -> torch.Tensor:
    """(S, m_max) local blocks -> (n_lambda,) additive dual assembly."""
    flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
    return flat[dm.first] + flat[dm.second]


def local_dual_apply(apply_local, dm: DualMap, lam: torch.Tensor
                     ) -> torch.Tensor:
    """gather(λ) → per-subdomain local apply → scatter-add back into λ."""
    return scatter_dual(apply_local(gather_local(lam, dm)), dm)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A_s x_s``: (S, a, b) · (S, b) -> (S, a)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _rmatvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A_sᵀ x_s``: (S, a, b) · (S, a) -> (S, b)."""
    return (A.mT @ x.unsqueeze(-1)).squeeze(-1)


def explicit_dual_apply(F: torch.Tensor, dm: DualMap, lam: torch.Tensor
                        ) -> torch.Tensor:
    """q = Σᵢ B̃ᵢᵀ-scatter( F̃ᵢ · gather(λ) )   (paper eq. 12)."""
    return local_dual_apply(lambda p: _matvec(F, p), dm, lam)


def solve_with_factor(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Apply (L Lᵀ)⁻¹ to a subdomain-stacked (S, n) right-hand side, with a
    dense (S, n, n) factor stack (packed factors are ROADMAP item A9)."""
    t = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, t, upper=True).squeeze(-1)


def apply_stiffness(K, v: torch.Tensor) -> torch.Tensor:
    """Batched ``Kᵢ vᵢ`` for a stiffness stack stored dense or packed."""
    if isinstance(K, PackedBlocks):
        return packed_symm_matvec(K, v)
    return _matvec(K, v)


def implicit_dual_apply(L: torch.Tensor, Btp: torch.Tensor, dm: DualMap,
                        lam: torch.Tensor) -> torch.Tensor:
    """q = Σᵢ scatter( B̃ᵢ L⁻ᵀL⁻¹ B̃ᵢᵀ gather(λ) )  (paper eq. 11)."""
    return local_dual_apply(
        lambda p: _rmatvec(Btp, solve_with_factor(L, _matvec(Btp, p))), dm, lam)


def lumped_preconditioner(K, Bt: torch.Tensor, dm: DualMap, w: torch.Tensor
                          ) -> torch.Tensor:
    """Lumped FETI preconditioner: M⁻¹ ≈ Σᵢ B̃ᵢ Kᵢ B̃ᵢᵀ.

    ``K`` is the unregularized stiffness stack — dense, or packed in the
    factor's block layout (what the preprocessor keeps); ``Bt`` shares K's
    row order.
    """
    return local_dual_apply(
        lambda p: _rmatvec(Bt, apply_stiffness(K, _matvec(Bt, p))), dm, w)


def dual_rhs(L: torch.Tensor, Btp: torch.Tensor, fp: torch.Tensor,
             dm: DualMap, c: torch.Tensor) -> torch.Tensor:
    """d = B K⁺ f − c (paper §2.1)."""
    return scatter_dual(_rmatvec(Btp, solve_with_factor(L, fp)), dm) - c
