"""The port's Dirichlet preconditioner (the primal boundary Schur stage
S_b = K_bb − K_bi K_ii⁻¹ K_ib) against the reference.

Both packages work on the identical decomposition (the reference's host
arrays carried over with ``repro_torch.interop``). The split, the
own-boundary masks and the symbolic products are compared exactly; the
restricted S_b stacks within 1e-12 relative, for dense and packed factors,
unfused and fused kernel paths (plain versions on the CPU), shared
(elasticity: the fixing DOFs sit on corners, so the dual factor's interior
block is reused) and unshared (heat: the fixing node is the centre). The
reference assembles with its default factor-split/input-split variants:
its fused Pallas kernels do not run on the installed jax (ROADMAP C1).
Solves are held to the scipy oracle (1e-8), the reference's iteration
count at the launcher's tolerance 1e-9 (one of its two modes' counts where
they differ), and strictly fewer iterations than lumped on elasticity.

The ``cuda`` case runs the Dirichlet stage's operands through each of the
five hand-written kernels against its plain version on the card. It needs
no JAX (the reference is imported inside the tests that use it), so the
card's machine runs it with
``python -m pytest --noconftest -m cuda tests/test_torch_dirichlet.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.fem import decompose_problem  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver, preprocess_cluster  # noqa: E402
from repro_torch.feti import assembly as feti_assembly  # noqa: E402
from repro_torch.feti import dirichlet as dirlib  # noqa: E402
from repro_torch.feti.operator import dirichlet_preconditioner  # noqa: E402
from repro_torch.interop import SUBDOMAIN_KEYS, from_reference_problem  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ops,
    stepped_syrk_kernel,
    stepped_syrk_plain,
    stepped_trsm_kernel,
    stepped_trsm_packed_kernel,
    stepped_trsm_packed_plain,
    stepped_trsm_plain,
    stepped_trsm_syrk_kernel,
    stepped_trsm_syrk_packed_kernel,
    stepped_trsm_syrk_packed_plain,
    stepped_trsm_syrk_plain,
)
from repro_torch.launch import solve_feti  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    PackedBlockIndex,
    block_cholesky,
    pack_factor,
)

pytestmark = pytest.mark.torch_port

TOL = 1e-12
SOLVE_TOL = 1e-9
# (decomposition, block size): the smoke configs at their bs = 8, and the
# 8x8-element elasticity grid at bs = 16, which the reference compiles in a
# third of the time bs = 8 takes
PROBLEMS = {
    "heat2d": (("heat", 2, (2, 2), (4, 4)), 8),
    "heat3d": (("heat", 3, (2, 2, 1), (3, 3, 3)), 8),
    "ela2d": (("elasticity", 2, (2, 2), (4, 4)), 8),
    "ela3d": (("elasticity", 3, (2, 2, 1), (2, 2, 2)), 8),
    "ela2d-8x8": (("elasticity", 2, (2, 2), (8, 8)), 16),
}
# (name, Schur config fields): every assembly path of the dual stage
PATHS = {
    "plain-dense": dict(),
    "kernels-dense": dict(use_kernels=True),
    "kernels-packed": dict(use_kernels=True, storage="packed"),
    "fused-dense": dict(use_kernels=True, fused=True),
    "fused-packed": dict(use_kernels=True, fused=True, storage="packed"),
}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _reference():
    """The reference modules, imported only by the tests that compare
    with them (the card's machine has no JAX)."""
    pytest.importorskip("jax")
    from repro.core import SchurAssemblyConfig as Config
    from repro.fem import decompose_problem as decompose
    from repro.feti import FetiConfig as FetiCfg
    from repro.feti import FetiSolver as Solver
    from repro.feti import dirichlet
    from repro.feti import preprocess_cluster as preprocess
    from repro.feti.operator import dirichlet_preconditioner as precond

    return types.SimpleNamespace(Config=Config, decompose=decompose,
                                 FetiConfig=FetiCfg, Solver=Solver,
                                 dirichlet=dirichlet, preprocess=preprocess,
                                 precond=precond)


def _carry(ref_prob):
    return from_reference_problem(dict(
        subdomains=[{k: getattr(sd, k)
                     for k in SUBDOMAIN_KEYS + ("node_gids", "fixing_node")}
                    for sd in ref_prob.subdomains],
        c=ref_prob.c, n_lambda=ref_prob.n_lambda,
        dirichlet_gids=ref_prob.dirichlet_gids,
        coords=ref_prob.global_mesh.coords, elems=ref_prob.global_mesh.elems,
        dim=ref_prob.dim, sub_grid=ref_prob.sub_grid,
        elems_per_sub=ref_prob.elems_per_sub, params=ref_prob.params,
        problem=ref_prob.problem, ndof_per_node=ref_prob.ndof_per_node))


def _config(bs=8, mode="implicit", **schur):
    return FetiConfig(schur=SchurAssemblyConfig(block_size=bs,
                                                rhs_block_size=bs, **schur),
                      mode=mode, preconditioner="dirichlet", device="cpu")


@pytest.fixture(scope="module", params=list(PROBLEMS))
def pair(request):
    """The port and reference problems, the reference's explicit Dirichlet
    state and the block size."""
    ref = _reference()
    args, bs = PROBLEMS[request.param]
    ref_prob = ref.decompose(*args)
    ref_state = ref.preprocess(ref_prob, ref.FetiConfig(
        schur=ref.Config(block_size=bs, rhs_block_size=bs),
        preconditioner="dirichlet", plan_cache=False))
    return types.SimpleNamespace(name=request.param, prob=_carry(ref_prob),
                                 ref_prob=ref_prob, ref_state=ref_state, bs=bs)


def test_split_and_symbolic_products_match_reference(pair):
    prob, ref_prob, bs = pair.prob, pair.ref_prob, pair.bs
    ref = _reference().dirichlet
    split = dirlib.boundary_interior_split(prob)
    want = ref.boundary_interior_split(ref_prob)
    assert split.n == want.n
    for k in ("interior", "boundary", "dperm"):
        np.testing.assert_array_equal(getattr(split, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_array_equal(dirlib.own_boundary_masks(prob, split),
                                  ref.own_boundary_masks(ref_prob, want))
    meta, mask = dirlib.dirichlet_symbolic(prob, split, bs)
    ref_meta, ref_mask = ref.dirichlet_symbolic(ref_prob, want, bs)
    np.testing.assert_array_equal(mask, ref_mask)
    for k in ("n", "m", "block_size", "rhs_block_size", "perm", "inv_perm",
              "pivots", "widths", "col_starts"):
        np.testing.assert_array_equal(getattr(meta, k), getattr(ref_meta, k),
                                      err_msg=k)


@pytest.mark.parametrize("path", list(PATHS))
def test_sb_matches_reference(pair, path):
    prob, ref_state = pair.prob, pair.ref_state
    st = preprocess_cluster(prob, _config(pair.bs, **PATHS[path]))
    assert (st.shared_factor == ref_state.shared_factor
            == pair.name.startswith("ela"))
    assert st.storage == PATHS[path].get("storage", "dense")
    _close(st.Sb, ref_state.Sb)
    _close(st.Btb, ref_state.Btb, tol=0)
    # the own-boundary restriction zeroes the spurious rows (to rounding)
    Z = torch.as_tensor(dirlib.own_boundary_masks(prob, st.split))
    spurious = (st.Sb * Z[:, :, None]).abs().max().item()
    assert spurious <= TOL * st.Sb.abs().max().item()


@pytest.mark.parametrize("storage", ["dense", "packed"])
@pytest.mark.parametrize("name", ["ela2d", "ela3d"])
def test_shared_and_unshared_interior_factors_agree(name, storage):
    prob = decompose_problem(*PROBLEMS[name][0])
    cfgs = [dataclasses.replace(_config(use_kernels=True, storage=storage),
                                share_factor=share)
            for share in ("auto", False)]
    shared, own = (preprocess_cluster(prob, c) for c in cfgs)
    assert shared.shared_factor and not own.shared_factor
    _close(shared.Sb, own.Sb)


def test_sharing_decision_and_its_error(pair):
    prob, ela = pair.prob, pair.name.startswith("ela")
    split = dirlib.boundary_interior_split(prob)
    assert feti_assembly._share_valid(prob, split) == ela
    forced = dataclasses.replace(_config(pair.bs), share_factor=True)
    if ela:
        assert preprocess_cluster(prob, forced).shared_factor
    else:
        with pytest.raises(ValueError, match="share_factor=True"):
            preprocess_cluster(prob, forced)
    with pytest.raises(ValueError, match="share_factor"):
        dataclasses.replace(_config(), share_factor="always")


def test_preconditioner_apply_matches_reference(pair):
    prob, ref_state = pair.prob, pair.ref_state
    ref = _reference()
    st = preprocess_cluster(prob, _config(pair.bs))
    w = np.random.default_rng(7).standard_normal(prob.n_lambda)
    got = dirichlet_preconditioner(st.Sb, st.Btb, st.dual,
                                   torch.as_tensor(w))
    want = ref.precond(ref_state.Sb, ref_state.Btb, ref_state.lambda_ids,
                       prob.n_lambda, w)
    _close(got, want)


def test_one_shot_assembly_matches_preprocessing(pair):
    prob, ref_prob, bs = pair.prob, pair.ref_prob, pair.bs
    ref = _reference().dirichlet
    cfg = SchurAssemblyConfig(block_size=bs, rhs_block_size=bs)
    union, Btb, split = dirlib.assemble_dirichlet_schur(
        prob, cfg, restrict=False, device="cpu")
    ref_union, ref_Btb, _ = ref.assemble_dirichlet_schur(
        ref_prob, _reference().Config(block_size=bs, rhs_block_size=bs),
        restrict=False)
    _close(union, ref_union)
    _close(Btb, ref_Btb, tol=0)
    st = preprocess_cluster(prob, _config(bs))
    Z = torch.as_tensor(dirlib.own_boundary_masks(prob, split))
    _close(dirlib.restrict_own_boundary(union, Z), st.Sb)


def test_dirichlet_solve_matches_oracle_and_reference(pair):
    """The iteration count must be one the reference takes. Its explicit
    and implicit modes (one factorization) stop an iteration apart where
    the residual crosses the bar within rounding (ROADMAP C3): 13 and 14
    on heat2d, 52 and 53 on ela3d at 1e-9; the other cases take one
    count."""
    prob, bs = pair.prob, pair.bs
    ref = _reference()
    counts = set()
    for mode in ("explicit", "implicit"):
        rs = ref.Solver(pair.ref_prob, ref.FetiConfig(
            schur=ref.Config(block_size=bs, rhs_block_size=bs), mode=mode,
            preconditioner="dirichlet", plan_cache=False))
        rs.state = pair.ref_state  # one explicit state serves both solves
        want = rs.solve(tol=SOLVE_TOL)
        assert want.converged
        counts.add(want.iterations)
    got = FetiSolver(prob, _config(bs, mode="explicit", use_kernels=True)
                     ).solve(tol=SOLVE_TOL)
    assert got.converged
    assert got.iterations in counts
    u_ref = prob.reference_solution()
    _close(got.u_global, u_ref, tol=1e-8)
    if prob.problem == "elasticity":
        lumped = FetiSolver(prob, dataclasses.replace(
            _config(bs, mode="explicit", use_kernels=True),
            preconditioner="lumped")).solve(tol=SOLVE_TOL)
        assert lumped.converged and got.iterations < lumped.iterations


def test_solver_guards_a_state_without_the_stage():
    prob = decompose_problem("heat", 2, (2, 2), (2, 2))
    cfg = _config()
    lumped = dataclasses.replace(cfg, preconditioner="lumped")
    solver = FetiSolver(prob, cfg)
    solver.state = preprocess_cluster(prob, lumped)
    with pytest.raises(ValueError, match="without the dirichlet stage"):
        solver.solve()


@pytest.mark.parametrize("arch", ["feti-heat-2d", "feti-heat-3d",
                                  "feti-elasticity-2d", "feti-elasticity-3d"])
def test_launcher_cpu_smoke_dirichlet(arch, capsys):
    rc = solve_feti.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--kernels", "--precond", "dirichlet", "--validate"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "precond=dirichlet" in out and "converged=True" in out
    shared = "elasticity" in arch
    assert f"shared_factor={shared}" in out


def test_launcher_overrides_problem_and_sub_grid(capsys):
    """``--problem`` overrides the architecture's workload; the depth is
    the architecture's own, as in the reference's launcher, which has no
    ``--sub-grid``."""
    rc = solve_feti.main(["--arch", "feti-heat-2d", "--smoke", "--device",
                          "cpu", "--problem", "elasticity", "--validate"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "problem=elasticity (2 DOF/node, kernel dim 3)" in out
    assert "sub_grid=(2, 2), 4 subdomains" in out
    with pytest.raises(SystemExit):
        solve_feti.main(["--arch", "feti-heat-2d", "--smoke", "--device",
                         "cpu", "--sub-grid", "3,1"])


def _stage_operands(prob, bs, device):
    """The Dirichlet stage's stepped operands, as the assembler hands them
    to the kernels: the interior factor (dense, padded, and packed), its
    diagonal inverses, K_ib in stepped column order, the start blocks and
    the fused item lists."""
    split = dirlib.boundary_interior_split(prob)
    meta, mask = dirlib.dirichlet_symbolic(prob, split, bs)
    blocks = dirlib.DirichletBlocks(split, prob.n_subdomains, device,
                                    interior=True).upload(prob)
    L = block_cholesky(blocks.Kii, bs, mask=mask)
    packed = pack_factor(L, PackedBlockIndex.from_mask(mask, split.n_i, bs))
    _, bm, n_pad, m_pad = ops._padded_sizes(meta)
    perm = torch.as_tensor(meta.perm, device=device)
    B = ops._pad_to(blocks.Kib[:, :, perm], n_pad, m_pad)
    Lp = ops.pad_factor(L, n_pad)
    S = prob.n_subdomains
    return dict(dense=(ops.invert_diag_blocks(Lp, bs), Lp),
                packed=ops._packed_operands(packed, meta), B=B,
                starts=ops._starts(meta, device), bs=bs, bm=bm,
                orders=(ops._fused_order(meta, S, device),
                        ops._fused_order(meta, S, device, packed.index)))


@pytest.mark.cuda
def test_cuda_kernels_on_the_dirichlet_stage():
    """Each of B1–B5 on the Dirichlet stage's operands against its plain
    version. bs = 32: the card's TRSM kernels take bs a multiple of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    prob = decompose_problem("heat", 3, (2, 2, 1), (6, 6, 6))
    x = _stage_operands(prob, 32, dev)
    B, st, bs, bm = x["B"], x["starts"], x["bs"], x["bm"]
    order, packed_order = x["orders"]
    cases = (
        (stepped_trsm_kernel, stepped_trsm_plain, x["dense"], {}),
        (stepped_trsm_packed_kernel, stepped_trsm_packed_plain, x["packed"],
         {}),
        (stepped_trsm_syrk_kernel, stepped_trsm_syrk_plain, x["dense"],
         dict(order=order)),
        (stepped_trsm_syrk_packed_kernel, stepped_trsm_syrk_packed_plain,
         x["packed"], dict(order=packed_order)),
    )
    for kernel, plain, factor, kw in cases:
        before = kernel.launches
        got = kernel(*factor, B, st, bs, bm, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = plain(*factor, B, st, bs, bm)
        assert (got - want).abs().max().item() <= 1e-11 * want.abs().max().item()
    Y = stepped_trsm_plain(*x["dense"], B, st, bs, bm)
    got = stepped_syrk_kernel(Y, st, bs, bm)
    want = stepped_syrk_plain(Y, st, bs, bm)
    assert (got - want).abs().max().item() <= 1e-11 * want.abs().max().item()
