"""The port's multi-RHS solve (``FetiSolver.solve_many``: the load cases,
the operators on column blocks, the block PCPG with per-column stopping and the
block defect-correction outers) against the reference.

Both packages get the identical decomposition (the reference's host arrays
carried over with ``repro_torch.interop``); the reference assembles with
its default variants, the port through its kernel path (the kernels' plain
versions on the CPU).

* ``load_cases``, ``global_load`` and ``reference_solutions`` equal the
  reference's.
* Each operator (rank-generic: the reference's ``*_many`` operators are
  its column-block form) maps a column block's column j as it maps that
  column alone (1e-13 relative at f64, 1e-5 where an f32 stack is
  applied), dense and packed, at f64 and refined f32.
* ``pcpg_many``: every column runs ``pcpg``'s iteration on its own (the
  same count, 1e-12 of its λ), a zero column takes 0 iterations, and a
  column's result does not depend on its neighbours.
* ``solve_many`` against the reference's at tol 1e-10, load sweeps and
  mixed batches, f64 explicit and implicit and f32 refined (explicit with
  the block outers, implicit, Dirichlet): every column within 1e-8 of
  ``reference_solutions`` (each against its own scale), per-column counts
  within one of the reference's (ROADMAP C3), the same number of outers.
* A batch of one is ``solve(loads=...)`` bit for bit; the history record
  and the input checks.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver, solve_many  # noqa: E402
from repro_torch.feti import operator as op  # noqa: E402
from repro_torch.feti.pcpg import pcpg, pcpg_many  # noqa: E402
from repro_torch.launch import solve_feti  # noqa: E402

from test_torch_dirichlet import _carry  # noqa: E402

pytestmark = pytest.mark.torch_port

SOLVE_TOL = 1e-10
ORACLE_TOL = 1e-8
N_RHS = 5


def _reference():
    pytest.importorskip("jax")
    from repro.core import SchurAssemblyConfig as Config
    from repro.fem import decompose_problem
    from repro.feti import FetiConfig as FetiCfg
    from repro.feti import FetiSolver as Solver

    return types.SimpleNamespace(Config=Config, decompose=decompose_problem,
                                 FetiConfig=FetiCfg, Solver=Solver)


@pytest.fixture(scope="module")
def heat():
    ref = _reference()
    ref_prob = ref.decompose("heat", 2, (2, 2), (4, 4))
    return types.SimpleNamespace(ref=ref, ref_prob=ref_prob,
                                 prob=_carry(ref_prob))


def _rel(got, want):
    got, want = (np.asarray(x, dtype=np.float64) for x in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _config(mode="explicit", dtype="f64", storage="dense",
            preconditioner="lumped", fused=False):
    return FetiConfig(
        schur=SchurAssemblyConfig(block_size=8, rhs_block_size=8,
                                  use_kernels=True, fused=fused),
        mode=mode, dtype=dtype, storage=storage,
        preconditioner=preconditioner, device="cpu")


# ---------------------------------------------------------------------------
# load cases and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sweep", "random", "mixed"])
def test_load_cases_match_reference(heat, kind):
    want = heat.ref_prob.load_cases(4, kind=kind, seed=3)
    got = heat.prob.load_cases(4, kind=kind, seed=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(heat.prob.load_stack(),
                                  heat.ref_prob.load_stack())
    for case in got:
        np.testing.assert_array_equal(heat.prob.global_load(case),
                                      heat.ref_prob.global_load(case))
    U = heat.prob.reference_solutions(got)
    assert U.shape == (4, heat.prob.n_global_dofs)
    assert _rel(U, heat.ref_prob.reference_solutions(want)) <= 1e-13
    assert _rel(U[0], heat.prob.reference_solution(got[0])) <= 1e-13
    if kind == "sweep":  # the solutions are the scaled base solution
        assert _rel(U[2], 3.0 * heat.prob.reference_solution()) <= 1e-13
    with pytest.raises(ValueError, match="kind"):
        heat.prob.load_cases(2, kind="bogus")


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_many_operators_are_the_single_ones_per_column(heat, storage, dtype):
    solver = FetiSolver(heat.prob, _config(storage=storage, dtype=dtype,
                                           preconditioner="dirichlet"))
    st = solver.preprocess()
    ops = solver._solution_ops()
    rng = np.random.default_rng(7)
    vdt = solver.config.solve_dtype
    Lam = torch.as_tensor(rng.standard_normal((heat.prob.n_lambda, 3)),
                          dtype=vdt)
    Fp = torch.as_tensor(rng.standard_normal((st.S, st.fp.shape[1], 3)),
                         dtype=vdt)
    fd = op._factor_dtype(st.L)
    pairs = [(ops.apply_F, Lam), (ops.apply_F_exact, Lam),
             (ops.precond, Lam), (ops.dual_rhs, Fp),
             (lambda x: op.solve_with_factor(st.L, x.to(fd)), Fp)]
    if dtype == "f32":
        pairs.append((
            lambda x: op.solve_with_factor_refined(st.L, st.Kreg, x, 2), Fp))
        pairs.append((lambda x: op.apply_stiffness(st.Kreg, x), Fp))
    else:
        pairs.append((
            lambda x: op.implicit_dual_apply(st.L, st.Btp, st.dual, x), Lam))
        pairs.append((lambda x: op.apply_stiffness(st.K, x), Fp))
    # a GEMM's column and a GEMV sum in other orders: f64 rounding, or f32
    # rounding where an operator runs on an f32 stack
    tol = 1e-13 if dtype == "f64" else 1e-5
    for apply, X in pairs:
        got = apply(X)
        one = apply(X[..., 0])
        assert got.shape[-1] == 3 and got.shape[:-1] == one.shape
        assert got.dtype == one.dtype
        for j in range(3):
            assert _rel(got[..., j], apply(X[..., j])) <= tol


# ---------------------------------------------------------------------------
# the block PCPG
# ---------------------------------------------------------------------------


def _spd_system(n=40, k=3, seed=0):
    """An SPD operator, a projector onto the orthogonal complement of k
    random columns and its apply as closures."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    F = torch.as_tensor(A @ A.T / n + np.diag(np.linspace(0.1, 10, n)))
    G = torch.as_tensor(np.linalg.qr(rng.standard_normal((n, k)))[0])

    def project(x):
        return x - G @ (G.T @ x)

    return (lambda x: F @ x), project, rng


def test_pcpg_many_columns_run_pcpg_alone():
    apply_F, project, rng = _spd_system()
    D = torch.as_tensor(rng.standard_normal((40, 4)))
    D[:, 1] = 0.0  # converged at the start
    D[:, 3] *= 1e3  # another scale, the same relative stopping
    res = pcpg_many(apply_F, project, D, torch.zeros_like(D), tol=1e-10,
                    max_iter=200, history=True)
    assert res.iterations[1] == 0 and res.converged.all()
    assert res.block_iterations == res.iterations.max()
    assert res.residual_history.shape == (res.block_iterations, 4)
    for j in (0, 2, 3):
        one = pcpg(apply_F, project, D[:, j], torch.zeros_like(D[:, j]),
                   tol=1e-10, max_iter=200)
        assert one.iterations == res.iterations[j]
        assert _rel(res.lam[:, j], one.lam) <= 1e-12
        # frozen after convergence: the record repeats its last value
        np.testing.assert_array_equal(
            res.residual_history[res.iterations[j] - 1:, j], res.residual[j])
    # a column's trajectory does not depend on its neighbours
    other = D.clone()
    other[:, 0] = torch.as_tensor(rng.standard_normal(40))
    again = pcpg_many(apply_F, project, other, torch.zeros_like(D),
                      tol=1e-10, max_iter=200)
    assert list(again.iterations[1:]) == list(res.iterations[1:])
    assert _rel(again.lam[:, 1:], res.lam[:, 1:]) <= 1e-14
    plain = pcpg_many(apply_F, project, D, torch.zeros_like(D), tol=1e-10,
                      max_iter=200)
    assert torch.equal(plain.lam, res.lam) and plain.residual_history is None


def test_pcpg_many_stops_at_max_iter():
    apply_F, project, rng = _spd_system(seed=1)
    D = torch.as_tensor(rng.standard_normal((40, 2)))
    res = pcpg_many(apply_F, project, D, torch.zeros_like(D), tol=1e-12,
                    max_iter=5)
    assert res.block_iterations == 5
    assert list(res.iterations) == [5, 5] and not res.converged.any()


# ---------------------------------------------------------------------------
# solve_many against the reference
# ---------------------------------------------------------------------------

CASES = {
    # name: (mode, dtype, storage, preconditioner, port fused)
    "f64-explicit": ("explicit", "f64", "dense", "lumped", False),
    "f64-implicit-packed": ("implicit", "f64", "packed", "lumped", False),
    "f32-explicit-fused": ("explicit", "f32", "dense", "lumped", True),
    "f32-implicit": ("implicit", "f32", "packed", "lumped", False),
    "f32-dirichlet-packed-fused": ("explicit", "f32", "packed", "dirichlet",
                                   True),
}


@pytest.mark.parametrize("kind", ["sweep", "mixed"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_many_matches_reference(heat, case, kind):
    mode, dtype, storage, precond, fused = CASES[case]
    ref = heat.ref
    cases = heat.prob.load_cases(N_RHS, kind=kind)
    want = ref.Solver(heat.ref_prob, ref.FetiConfig(
        schur=ref.Config(block_size=8, rhs_block_size=8, storage=storage),
        mode=mode, dtype=dtype, preconditioner=precond, plan_cache=False)
    ).solve_many(cases, tol=SOLVE_TOL)
    got = FetiSolver(heat.prob, _config(mode, dtype, storage, precond, fused)
                     ).solve_many(cases, tol=SOLVE_TOL)
    U = heat.prob.reference_solutions(cases)
    assert got.u_global.shape == U.shape == want.u_global.shape
    assert got.converged.all() and want.converged.all()
    for j in range(N_RHS):  # each column against its own scale
        scale = np.abs(U[j]).max() or np.abs(U).max()  # the zero load
        assert np.abs(got.u_global[j] - U[j]).max() <= ORACLE_TOL * scale
    assert np.all(np.abs(got.iterations - want.iterations) <= 1), (
        got.iterations, want.iterations)
    assert got.refine_outer == want.refine_outer
    if mode == "explicit" and dtype == "f32":
        assert got.refine_outer >= 1
    if kind == "mixed":
        assert got.iterations[1] == 0  # the zero load
    assert (got.storage_dtype, got.solve_dtype) == (dtype, "f64")
    assert got.lam.shape == (N_RHS, heat.prob.n_lambda)
    assert got.alpha.shape == (N_RHS, heat.prob.n_subdomains, 1)
    assert got.u.shape == (N_RHS, heat.prob.n_subdomains,
                           heat.prob.subdomains[0].n)


def test_one_column_batch_is_solve(heat):
    solver = FetiSolver(heat.prob, _config())
    base = heat.prob.load_stack()
    one = solver.solve_many(base, tol=SOLVE_TOL)
    alone = solver.solve(tol=SOLVE_TOL, loads=base)
    own = solver.solve(tol=SOLVE_TOL)
    assert one.n_rhs == 1
    np.testing.assert_array_equal(one.lam[0], alone.lam)
    np.testing.assert_array_equal(one.u_global[0], alone.u_global)
    assert one.iterations[0] == alone.iterations == own.iterations
    # the problem's own load given as loads= is the problem's own solve
    np.testing.assert_array_equal(alone.lam, own.lam)


def test_history_changes_no_multiplier(heat):
    solver = FetiSolver(heat.prob, _config(dtype="f32"))
    cases = heat.prob.load_cases(3, kind="mixed")
    plain = solver.solve_many(cases, tol=SOLVE_TOL)
    rec = solver.solve_many(cases, tol=SOLVE_TOL, history=True)
    assert plain.residual_history is None and rec.n_rhs == 3
    np.testing.assert_array_equal(rec.lam, plain.lam)
    assert list(rec.iterations) == list(plain.iterations)
    H = rec.residual_history
    # one row per column, one entry per block trip across the outers
    assert H.shape == (3, rec.block_iterations)
    for j in range(3):
        if rec.iterations[j]:
            assert np.all(np.isfinite(H[j]))


def test_solve_many_checks_its_input(heat):
    solver = FetiSolver(heat.prob, _config())
    with pytest.raises(ValueError, match="loads must be"):
        solver.solve_many(np.zeros((2, 3, 4)))


def test_module_solve_many_is_the_method(heat):
    cases = heat.prob.load_cases(3, kind="sweep")
    got = solve_many(heat.prob, cases, _config(), tol=SOLVE_TOL)
    want = FetiSolver(heat.prob, _config()).solve_many(cases, tol=SOLVE_TOL)
    np.testing.assert_array_equal(got.lam, want.lam)
    # a sweep's columns are the scaled first column
    assert _rel(got.u_global[2], 3.0 * got.u_global[0]) <= 1e-10


@pytest.mark.parametrize("flags", [["--kernels"],
                                   ["--storage", "packed", "--fused",
                                    "--dtype", "f32"]])
def test_launcher_n_rhs(flags, capsys):
    rc = solve_feti.main(["--smoke", "--device", "cpu", "--n-rhs", "3",
                          "--validate", *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "n_rhs=3 iters=[" in out and "converged=True" in out
    err = float(out.split("max per-column rel err vs global solves: ")[1]
                .split()[0])
    assert err <= 1e-8
