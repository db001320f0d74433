"""Distributed FETI: the subdomain axis split over ``torch.distributed``
ranks (counterpart of ``repro.feti.sharded``).

One process (rank) a device, each described by a
:class:`~repro_torch.launch.mesh.FetiMesh` in ``FetiConfig.mesh``. Every
rank owns a contiguous slice of the subdomains
(:meth:`~repro_torch.launch.mesh.FetiMesh.owned`) and runs the port's
single-device code on it end to end: its factors, F̃ᵢ and S_b, with the
same kernels a single-device run launches. Dual (λ) vectors stay whole on
every rank, so PCPG is unchanged; the per-subdomain scatter into λ-space,
the reference's ``psum``, is one ``all_reduce(SUM)`` here.

Design notes:

* **One wrapper.** :func:`reduce_sum` turns any single-device λ-space
  operator of :mod:`repro_torch.feti.operator`, run on the rank's stacks,
  into its sharded form: the rank's partial sum, all-reduced. The port's
  operators are rank-generic, so it covers the explicit, implicit and
  refined dual apply and the lumped and Dirichlet preconditioners, one
  right-hand side or a column block of them (the reference's twenty
  ``shard_map`` twins), and the right-hand side's load half
  (:func:`~repro_torch.feti.operator.dual_load` and its refined form),
  from which the solver subtracts ``c`` once, after the all-reduce. The
  per-rank body stays the plain operator: the tests sum the slices'
  partials in one process.
* **Bit-identical sums.** On a slice the :class:`~repro_torch.feti.
  operator.DualMap` is built ``sliced``: a copy that lives on another rank
  reads the zero slot. Every rank's partial then holds at most a
  multiplier's two copies and exact zeros, and the all-reduced sum is
  ``x₁ + x₂`` in any order of the ranks: the sharded operators equal the
  single-device ones bit for bit wherever the per-subdomain products do.
* **Uneven slices, no dummies.** The slices' sizes differ by at most one
  (``torch.tensor_split``'s). The reference pads the subdomain count to a
  multiple of the mesh (``padded_count``/``pad_stack``) because GSPMD needs
  equal shards; ranks do not.
* **Segment assembly.** A subdomain-indexed vector (Rᵀf, Gᵀx, the
  recovered u) is assembled by :func:`assemble_segments`: each rank writes
  its rows into a zero buffer of the full size, one all-reduce. Exact: one
  rank owns each entry.
* **No relabeling.** The reference relabels B̃ᵀ's columns host-side
  (``relabel_columns``) so that GSPMD need not replicate a batched gather
  by the stepped column permutation. Each rank here runs that gather on
  its own stacks (``col_perm``), so there is nothing to partition and
  nothing to relabel.
* **The coarse problem** (:class:`ShardedCoarseProblem`): G = BR stays
  column-sharded, each rank holding its subdomains' k columns (a
  replicated G does not scale to real clusters). Gᵀx is a local product,
  then segment-assembled; G t is the rank's partial product, all-reduced.
  The Gram factor comes from G gathered once at setup (segment assembly)
  through :func:`repro_torch.feti.projector.coarse_factor`, so it is the
  single-device factor bit for bit. Only the partial sums of G t change
  order against one device.

A PCPG iteration makes six all-reduces: the dual apply, the
preconditioner and two for each of its two projections. Every value PCPG
stops on comes out of an all-reduce, the same bits on every rank, so the
ranks stay in step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.feti.operator import DualMap
from repro_torch.feti.projector import (
    CoarseProblem,
    coarse_factor,
    coarse_g_e,
)
from repro_torch.feti.projector import coarse_e as _coarse_e
from repro_torch.launch.mesh import FetiMesh

__all__ = ["ShardedCoarseProblem", "assemble_segments",
           "build_coarse_problem", "coarse_e", "coarse_e_many",
           "place_segment", "reduce_sum", "solve_cases"]


def reduce_sum(mesh: FetiMesh, fn: Callable) -> Callable:
    """``fn`` (a λ-space operator on this rank's stacks) with its output
    all-reduced over the ranks: the sharded form of any operator of
    :mod:`repro_torch.feti.operator`."""
    def apply(*args, **kwargs):
        return mesh.all_reduce(fn(*args, **kwargs))

    return apply


def place_segment(local: torch.Tensor, start: int, total: int
                  ) -> torch.Tensor:
    """``local``'s rows at ``start`` of a zero tensor of ``total`` rows:
    one rank's share of a segment assembly."""
    out = local.new_zeros((total,) + local.shape[1:])
    out[start:start + local.shape[0]] = local
    return out


def assemble_segments(mesh: FetiMesh, local: torch.Tensor, start: int,
                      total: int) -> torch.Tensor:
    """The (total, ...) tensor whose rows ``start:start + len(local)`` are
    this rank's ``local`` (each rank its own rows): one all-reduce of the
    ranks' :func:`place_segment`, exact since one rank owns each row."""
    return mesh.all_reduce(place_segment(local, start, total))


def coarse_e(mesh: FetiMesh, f: torch.Tensor, R: torch.Tensor,
             owned: range, S: int) -> torch.Tensor:
    """e = Rᵀf on every rank, (S·k,) subdomain-major, from this rank's
    (S_r, n) loads and kernel bases of its ``owned`` subdomains; an
    (S_r, n, n_rhs) load-case stack gives (S·k, n_rhs)."""
    k = R.shape[2]
    return assemble_segments(mesh, _coarse_e(f, R), owned.start * k, S * k)


coarse_e_many = coarse_e  # rank-generic, as the port's own coarse_e


@dataclasses.dataclass
class ShardedCoarseProblem(CoarseProblem):
    """Natural coarse space with G = BR column-sharded over the ranks.

    ``G`` holds this rank's subdomains' columns, (n_lambda, S_r·k); the
    (S·k, S·k) Gram factor and e = Rᵀf are whole on every rank
    (``solve_coarse`` is inherited). Every method is rank-generic over a
    trailing column axis, as the single-device one.
    """

    mesh: FetiMesh
    owned: range  # this rank's subdomains
    S: int  # subdomains of the cluster

    @property
    def _cols(self) -> slice:
        """This rank's columns of the whole G."""
        k = self.G.shape[1] // len(self.owned)
        return slice(self.owned.start * k, self.owned.stop * k)

    def _gt_x(self, x: torch.Tensor) -> torch.Tensor:
        """Gᵀ x on every rank: this rank's rows locally, then assembled."""
        return assemble_segments(self.mesh, self.G.T @ x, self._cols.start,
                                 self.GtG_chol.shape[0])

    def _g_t(self, t: torch.Tensor) -> torch.Tensor:
        """G t: this rank's columns' partial product, all-reduced."""
        return self.mesh.all_reduce(self.G @ t[self._cols])

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """P x = x − G (GᵀG)⁻¹ Gᵀ x (two all-reduces)."""
        return x - self._g_t(self.solve_coarse(self._gt_x(x)))

    def lambda0(self, e: torch.Tensor = None) -> torch.Tensor:
        """λ⁰ = G(GᵀG)⁻¹e; ``e`` as in the single-device problem, whole
        (:func:`coarse_e`)."""
        return self._g_t(self.solve_coarse(self.e if e is None else e))

    def alpha(self, Flam_minus_d: torch.Tensor) -> torch.Tensor:
        """α = (GᵀG)⁻¹Gᵀ(Fλ − d), whole on every rank."""
        return self.solve_coarse(self._gt_x(Flam_minus_d))


def build_coarse_problem(mesh: FetiMesh, Bt: torch.Tensor, f: torch.Tensor,
                         R: torch.Tensor, dm: DualMap, owned: range,
                         S: int) -> ShardedCoarseProblem:
    """G = BR (column-sharded) and e = Rᵀf from this rank's stacks of its
    ``owned`` subdomains (``dm`` the slice's map, ``Bt`` and ``R`` in one
    row order). The Gram factor comes from G assembled whole once, so it is
    the single-device :func:`~repro_torch.feti.projector.coarse_factor`'s
    bit for bit."""
    G, e = coarse_g_e(Bt, f, R, dm)
    k = R.shape[2]
    G_all = assemble_segments(mesh, G.T, owned.start * k, S * k)
    chol = coarse_factor(G_all.T.contiguous())
    del G_all
    e = assemble_segments(mesh, e, owned.start * k, S * k)
    return ShardedCoarseProblem(G=G, GtG_chol=chol, e=e, mesh=mesh,
                                owned=owned, S=S)


# --------------------------------------------------------------------------
# the rank's body: solves of registered architectures on one mesh
# --------------------------------------------------------------------------

def solve_cases(mesh: FetiMesh, cases) -> list:
    """Run each case on this rank of ``mesh``: the rank entry point of the
    launcher's ``--devices`` and of the sharded tests (through
    :func:`repro_torch.launch.mesh.spawn_ranks`).

    A case is a dict: ``arch`` (a registered FETI architecture), ``smoke``
    (its smoke size), ``problem`` (``None``: the architecture's), ``config``
    (:class:`~repro_torch.feti.FetiConfig` keywords but ``mesh`` and
    ``device``), ``n_rhs`` (0: the problem's own load through ``solve``;
    else a sweep of that many cases through ``solve_many``) and ``tol``.
    Every rank decomposes the whole problem: the symbolic phase needs
    every subdomain's pattern; only the rank's own K_i reach its device.
    Returns, per case, this rank's solution and what it did: its
    subdomains, kernel launches per kernel and dtype, preprocess and solve
    seconds, peak device bytes (CUDA), stack bytes, all-reduces (all, and
    those of PCPG) and their host seconds and, under ``schur="auto"``, its
    plan.
    """
    from repro_torch import kernels
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.fem import decompose_problem
    from repro_torch.feti.config import FetiConfig
    from repro_torch.feti.solver import FetiSolver

    problems = {}
    out = []
    dev = mesh.device
    for case in cases:
        arch = case["arch"]
        key = (arch, case.get("smoke", False), case.get("problem"))
        if key not in problems:
            fc = get_smoke_config(arch) if key[1] else get_config(arch)
            prob = decompose_problem(key[2] or fc.problem, fc.dim,
                                     fc.sub_grid, fc.elems_per_sub)
            problems[key] = prob
        prob = problems[key]
        config = FetiConfig(mesh=mesh, **case.get("config", {}))
        kernels.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        reduces0, reduce_s0 = mesh.all_reduces, mesh.all_reduce_s
        solver = FetiSolver(prob, config)
        solver.preprocess()
        n_rhs = case.get("n_rhs", 0)
        tol = case.get("tol", 1e-9)
        if n_rhs:
            sol = solver.solve_many(prob.load_cases(n_rhs, kind="sweep"),
                                    tol=tol)
        else:
            sol = solver.solve(tol=tol)
        pcpg = solver.telemetry.tracer.last("pcpg")
        st = solver.state
        plans = None
        if st.graph_plan is not None:
            plans = {name: dataclasses.asdict(p.cfg)
                     for name, p in st.graph_plan.plans.items()}
        out.append(dict(
            rank=mesh.rank, world_size=mesh.world_size, device=str(dev),
            owned=(st.owned.start, st.owned.stop),
            solution=sol,
            launches=kernels.launch_counts(),
            preprocess_s=solver.timings["preprocess_s"],
            solve_s=solver.timings["solve_many_s" if n_rhs else "solve_s"],
            peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
            device_bytes={k: v for k, v in st.device_bytes().items()
                          if k != "per_stage"},
            all_reduces=mesh.all_reduces - reduces0,
            all_reduce_s=mesh.all_reduce_s - reduce_s0,
            pcpg_all_reduces=pcpg.attrs["all_reduces"],
            plans=plans,
        ))
        del solver, st
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out

