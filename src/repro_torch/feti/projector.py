"""Natural coarse space of FETI: G = BR, the projector
P = I − G(GᵀG)⁻¹Gᵀ, and the α recovery (paper §2.1, eqs. 4–7);
counterpart of ``repro.feti.projector``.

``R`` is the subdomain-stacked kernel basis (S, n, k); each subdomain
contributes k columns to G, so G is (n_lambda, S·k) and α the flattened
(S·k,) vector of kernel coefficients. The triangular coarse factor comes
from a QR of G (R from ``qr(G)`` IS the Cholesky factor of GᵀG up to row
signs) instead of factorizing the squared GᵀG.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.feti.operator import DualMap

__all__ = ["CoarseProblem", "build_coarse_problem", "coarse_g_e",
           "coarse_e", "coarse_factor"]


def coarse_g_e(Bt: torch.Tensor, f: torch.Tensor, R: torch.Tensor,
               dm: DualMap):
    """G = BR columns (n_lambda, S·k), subdomain-major, and e = Rᵀf (S·k,).

    Each (multiplier, subdomain) pair occurs at most once, so placing the
    local products needs no accumulation order.
    """
    S, _, k = R.shape
    vals = torch.einsum("snm,snk->smk", Bt, R)  # (S, m_max, k)
    s_idx = torch.arange(S, device=Bt.device)[:, None].expand_as(dm.lambda_ids)
    G = Bt.new_zeros((dm.n_lambda + 1, S, k))
    G.index_put_((dm.lambda_ids, s_idx), vals, accumulate=True)
    G = G[:-1].reshape(dm.n_lambda, S * k)
    return G, coarse_e(f, R)


def coarse_e(f: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """e = Rᵀf for one (S, n) load stack."""
    S, _, k = R.shape
    return torch.einsum("sn,snk->sk", f, R).reshape(S * k)


def coarse_factor(G: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L Lᵀ = GᵀG, as Rᵀ of the QR of G.

    Row signs are normalized so the diagonal is positive. Degenerate
    pivots (zero or eps-sized diagonals of a rank-deficient G) are clamped
    to the reference's floor, sqrt(1e-12 · ‖G‖²_F / ncols) for f64, keeping
    the coarse solve bounded; healthy pivots pass through unchanged. Fewer
    rows than columns are zero-padded.
    """
    n_rows, ncols = G.shape
    if n_rows < ncols:
        G = torch.cat([G, G.new_zeros((ncols - n_rows, ncols))])
    Rq = torch.linalg.qr(G, mode="r").R
    diag = torch.diagonal(Rq)
    floor_fac = max(1e-12, (torch.finfo(G.dtype).eps * 1e3) ** 2)
    floor2 = floor_fac * torch.sum(G * G) / ncols
    floor2 = torch.where(floor2 == 0.0, torch.ones_like(floor2), floor2)
    sign_d = torch.where(diag < 0, -1.0, 1.0).to(diag.dtype)
    safe = torch.where(diag * diag < floor2, torch.sqrt(floor2) * sign_d, diag)
    Rq = Rq.clone()
    Rq.diagonal().copy_(safe)
    sign = torch.sign(torch.diagonal(Rq))
    return (Rq * sign[:, None]).T


@dataclasses.dataclass
class CoarseProblem:
    G: torch.Tensor  # (n_lambda, S·k)
    GtG_chol: torch.Tensor  # (S·k, S·k) lower factor of GᵀG (QR-derived)
    e: torch.Tensor  # (S·k,) = Rᵀf, subdomain-major

    def solve_coarse(self, b: torch.Tensor) -> torch.Tensor:
        """(GᵀG)⁻¹ b via the cached triangular factor."""
        t = torch.linalg.solve_triangular(self.GtG_chol, b[:, None], upper=False)
        return torch.linalg.solve_triangular(
            self.GtG_chol.T, t, upper=True)[:, 0]

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """P x = x − G (GᵀG)⁻¹ Gᵀ x."""
        return x - self.G @ self.solve_coarse(self.G.T @ x)

    def lambda0(self) -> torch.Tensor:
        """Feasible start: λ⁰ = G(GᵀG)⁻¹e satisfies Gᵀλ⁰ = e."""
        return self.G @ self.solve_coarse(self.e)

    def alpha(self, Flam_minus_d: torch.Tensor) -> torch.Tensor:
        """α = (GᵀG)⁻¹Gᵀ(Fλ − d): (S·k,), reshape to (S, k) per subdomain."""
        return self.solve_coarse(self.G.T @ Flam_minus_d)


def build_coarse_problem(Bt: torch.Tensor, f: torch.Tensor, R: torch.Tensor,
                         dm: DualMap) -> CoarseProblem:
    """Assemble G = BR (R = stacked kernel bases) and e = Rᵀf. ``Bt`` and
    ``R`` must share a row order (the original DOF order is used)."""
    G, e = coarse_g_e(Bt, f, R, dm)
    return CoarseProblem(G=G, GtG_chol=coarse_factor(G), e=e)
