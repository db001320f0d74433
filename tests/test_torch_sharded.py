"""The subdomain-sharded FETI pipeline (``repro_torch.feti.sharded``,
``repro_torch.launch.mesh``) against the single-device port and the
reference, on gloo ranks on the CPU at the smoke sizes.

In one process:

* the slices' partial sums of the dual apply (explicit and implicit), the
  lumped and Dirichlet preconditioners and the dual load equal the
  unsharded operators bit for bit, on one vector and on a column block;
* each rank's preprocessing (no collective outside ``schur="auto"``) gives
  the single-device stacks' rows (F̃ within 1e-14) and stack bytes that sum
  to the single device's;
* the coarse problem's G, e and Gram factor from the slices' segments are
  the single-device ones bit for bit.

Spawned (``spawn_ranks``; world sizes 1, 2 and 3 over the 4-subdomain
smoke configurations, 3 giving uneven slices): heat explicit and implicit,
elasticity-3d with Dirichlet, packed storage, f32 with refinement,
``solve_many`` with 3 columns and ``schur="auto"``. Every rank returns the
same solution, within 1e-9 of the port's single-device solve with its
iteration count (the smoke elasticity-3d Dirichlet solve: 52 or 53, its
rounding-level count, ROADMAP C3) and, for heat explicit and implicit,
elasticity-3d Dirichlet and ``solve_many``, of the reference's (either of
its explicit and implicit counts where they disagree); world size 1 is
bit-identical to ``mesh=None``; under ``schur="auto"`` every rank runs
rank 0's plan and only rank 0 writes the plan cache. A rank that fails ends the run. The launcher's ``--devices``
checks itself (``--validate``). One ``cuda`` case: two gloo ranks on one
card with the kernels.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.fem import decompose_problem  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver, preprocess_cluster  # noqa: E402
from repro_torch.feti import operator as op  # noqa: E402
from repro_torch.feti import sharded  # noqa: E402
from repro_torch.feti.projector import coarse_factor, coarse_g_e  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import solve_feti  # noqa: E402
from repro_torch.sparse import PackedBlocks  # noqa: E402

pytestmark = pytest.mark.torch_port

SCHUR = SchurAssemblyConfig(block_size=8, rhs_block_size=8, use_kernels=True)
PROBLEMS = {"heat": ("feti-heat-2d", ("heat", 2, (2, 2), (4, 4))),
            "ela3d": ("feti-elasticity-3d",
                      ("elasticity", 3, (2, 2, 1), (2, 2, 2)))}
# name: (problem, FetiConfig keywords, n_rhs)
CASES = {
    "heat-explicit": ("heat", dict(), 0),
    "heat-implicit": ("heat", dict(mode="implicit"), 0),
    "ela3d-dirichlet": ("ela3d", dict(preconditioner="dirichlet"), 0),
    "heat-packed": ("heat", dict(storage="packed"), 0),
    "heat-f32": ("heat", dict(dtype="f32"), 0),
    "heat-many": ("heat", dict(), 3),
    "heat-auto": ("heat", dict(schur="auto", measure="never"), 0),
}
WORLDS = {1: ("heat-explicit", "ela3d-dirichlet"),
          2: ("heat-explicit", "ela3d-dirichlet", "heat-many", "heat-f32"),
          3: tuple(CASES)}
U_TOL = 1e-9


def _problem(name):
    return decompose_problem(*PROBLEMS[name][1])


def _config(**kw):
    kw.setdefault("schur", SCHUR)
    return FetiConfig(device="cpu", **kw)


def _case(name):
    prob, kw, n_rhs = CASES[name]
    kw = dict(kw)
    kw.setdefault("schur", SCHUR)
    return dict(arch=PROBLEMS[prob][0], smoke=True, config=kw, n_rhs=n_rhs)


def _solve_single(prob, config, n_rhs):
    solver = FetiSolver(prob, config)
    if n_rhs:
        return solver.solve_many(prob.load_cases(n_rhs, kind="sweep"))
    return solver.solve()


def _slices(S, world):
    return [range(lo, lo + n) for lo, n in
            zip(np.cumsum([0] + meshlib.split_sizes(S, world)[:-1]),
                meshlib.split_sizes(S, world))]


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------


def test_split_sizes_and_owned_slices():
    assert meshlib.split_sizes(4, 3) == [2, 1, 1]
    assert meshlib.split_sizes(8, 3) == [3, 3, 2]
    assert meshlib.split_sizes(64, 2) == [32, 32]
    assert [len(s) for s in torch.tensor_split(torch.arange(8), 3)] \
        == meshlib.split_sizes(8, 3)
    owned = [meshlib.FetiMesh(r, 3, "cpu").owned(8) for r in range(3)]
    assert owned == [range(0, 3), range(3, 6), range(6, 8)]
    with pytest.raises(ValueError, match="at least one"):
        meshlib.split_sizes(2, 3)
    with pytest.raises(ValueError, match="outside"):
        meshlib.FetiMesh(3, 3, "cpu")


def test_backend_choice_never_falls_back(monkeypatch):
    with pytest.raises(ValueError, match="backend='gloo'"):
        meshlib.rank_devices(2, None, "cpu")
    with pytest.raises(ValueError, match="backend='gloo'"):
        meshlib.rank_devices(2, "nccl", "cpu")
    assert meshlib.rank_devices(3, "gloo", "cpu") == (
        "gloo", [torch.device("cpu")] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 cards"):
        meshlib.rank_devices(2, None, "cuda")
    backend, devs = meshlib.rank_devices(2, "gloo", "cuda")
    assert backend == "gloo" and devs == [torch.device("cuda", 0)] * 2
    assert "2 ranks share 1 card" in meshlib.describe(backend, devs)
    with pytest.raises(SystemExit, match="2 ranks need 2 cards"):
        solve_feti.main(["--smoke", "--devices", "2"])


def test_sliced_dual_map_points_missing_copies_at_zero():
    prob = _problem("heat")
    lam = np.stack([sd.lambda_ids for sd in prob.subdomains])
    with pytest.raises(ValueError, match="one or two local copies"):
        op.dual_map(lam[:2], prob.n_lambda, torch.device("cpu"))
    dm = op.dual_map(lam[:2], prob.n_lambda, torch.device("cpu"), sliced=True)
    zero = lam[:2].size
    present = np.isin(np.arange(prob.n_lambda), lam[:2])
    assert (dm.first.numpy()[~present] == zero).all()
    assert (dm.second.numpy()[~present] == zero).all()
    assert (dm.first.numpy()[present] < zero).all()
    full = op.dual_map(lam, prob.n_lambda, torch.device("cpu"))
    assert torch.equal(full.first, op.dual_map(
        lam, prob.n_lambda, torch.device("cpu"), sliced=True).first)


@pytest.fixture(scope="module")
def single_heat9():
    """The single-device explicit Dirichlet state of heat on 3 x 3
    subdomains: every slice of 2 to 4 ranks holds two or more subdomains.
    (On the CPU a one-subdomain GEMV takes another BLAS path than the
    batched one and lands ~1e-14 away: bit-identity needs equal
    per-subdomain products, which the launched ranks' slices have.)"""
    prob = decompose_problem("heat", 2, (3, 3), (4, 4))
    config = _config(preconditioner="dirichlet")
    return prob, config, preprocess_cluster(prob, config)


@pytest.fixture(scope="module")
def single_ela3d():
    """The single-device explicit Dirichlet state of elasticity-3d smoke."""
    prob = _problem("ela3d")
    config = _config(preconditioner="dirichlet")
    return prob, config, preprocess_cluster(prob, config)


def _sliced_state(st, prob, rows):
    """The stacks of subdomains ``rows`` of a single-device state."""
    lam = np.stack([sd.lambda_ids for sd in prob.subdomains])
    sl = slice(rows.start, rows.stop)
    return types.SimpleNamespace(
        dual=op.dual_map(lam[sl], prob.n_lambda, torch.device("cpu"),
                         sliced=True),
        F=st.F[sl], L=st.L[sl], Btp=st.Btp[sl],
        K=PackedBlocks(st.K.values[sl], st.K.index), Sb=st.Sb[sl],
        Btb=st.Btb[sl], fp=st.fp[sl])


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("columns", [0, 3])
def test_slice_partials_sum_to_the_unsharded_operators_bit_for_bit(
        single_heat9, world, columns):
    prob, _, st = single_heat9
    rng = np.random.default_rng(world)
    shape = (prob.n_lambda,) + ((columns,) if columns else ())
    lam = torch.as_tensor(rng.standard_normal(shape))
    fp = torch.as_tensor(rng.standard_normal(
        st.fp.shape + ((columns,) if columns else ())))
    ops = {
        "explicit": lambda s, x: op.explicit_dual_apply(s.F, s.dual, x),
        "implicit": lambda s, x: op.implicit_dual_apply(s.L, s.Btp, s.dual, x),
        "lumped": lambda s, x: op.lumped_preconditioner(s.K, s.Btp, s.dual, x),
        "dirichlet": lambda s, x: op.dirichlet_preconditioner(
            s.Sb, s.Btb, s.dual, x),
    }
    parts = [(rows, _sliced_state(st, prob, rows))
             for rows in _slices(st.S, world)]
    for name, apply in ops.items():
        want = apply(st, lam)
        got = sum(apply(s, lam) for _, s in parts)
        assert torch.equal(got, want), name
    want = op.dual_load(st.L, st.Btp, fp, st.dual)
    got = sum(op.dual_load(s.L, s.Btp, fp[r.start:r.stop], s.dual)
              for r, s in parts)
    assert torch.equal(got, want)
    c = torch.as_tensor(rng.standard_normal(prob.n_lambda))
    assert torch.equal(op._minus_c(got, c),
                       op.dual_rhs(st.L, st.Btp, fp, st.dual, c))


@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_rank_preprocessing_gives_the_single_device_rows(single_ela3d,
                                                         storage):
    prob, _, _ = single_ela3d
    config = _config(preconditioner="dirichlet", storage=storage)
    st = preprocess_cluster(prob, config)
    total = dict.fromkeys(("L", "K", "Btp", "F", "Sb", "Btb", "Kreg"), 0)
    for rank, rows in enumerate(_slices(st.S, 3)):
        mesh = meshlib.FetiMesh(rank, 3, "cpu")
        part = preprocess_cluster(prob, config.replace(mesh=mesh))
        sl = slice(rows.start, rows.stop)
        assert part.owned == rows and part.S == len(rows)
        assert part.mesh is mesh
        np.testing.assert_array_equal(part.env.col_starts, st.env.col_starts)
        assert torch.equal(part.col_perm, st.col_perm[sl])
        F_err = (part.F - st.F[sl]).abs().max().item()
        assert F_err <= 1e-14 * st.F.abs().max().item(), F_err
        Lp = part.L.values if storage == "packed" else part.L
        Ls = (st.L.values if storage == "packed" else st.L)[sl]
        assert (Lp - Ls).abs().max().item() <= 1e-14 * Ls.abs().max().item()
        assert (part.Sb - st.Sb[sl]).abs().max().item() \
            <= 1e-14 * st.Sb.abs().max().item()
        assert torch.equal(part.Btb, st.Btb[sl])
        assert torch.equal(part.fp, st.fp[sl])
        by = part.device_bytes()
        for k in total:
            total[k] += by[k]
    one = st.device_bytes()
    assert total == {k: one[k] for k in total}


def test_coarse_segments_give_the_single_device_factor_bit_for_bit(
        single_ela3d):
    prob, _, st = single_ela3d
    Bt = torch.as_tensor(np.stack([sd.Bt for sd in prob.subdomains]))
    G, e = coarse_g_e(Bt, st.f, st.R, st.dual)
    k = st.R.shape[2]
    lam = np.stack([sd.lambda_ids for sd in prob.subdomains])
    for world in (2, 3):
        G_t = e_all = 0
        for rows in _slices(st.S, world):
            sl = slice(rows.start, rows.stop)
            dm = op.dual_map(lam[sl], prob.n_lambda, torch.device("cpu"),
                             sliced=True)
            G_r, e_r = coarse_g_e(Bt[sl], st.f[sl], st.R[sl], dm)
            assert torch.equal(G_r, G[:, rows.start * k:rows.stop * k])
            G_t = G_t + sharded.place_segment(G_r.T, rows.start * k,
                                              st.S * k)
            e_all = e_all + sharded.place_segment(e_r, rows.start * k,
                                                  st.S * k)
        G_all = G_t.T.contiguous()
        assert torch.equal(G_all, G) and torch.equal(e_all, e)
        assert torch.equal(coarse_factor(G_all), coarse_factor(G))


def test_feti_config_takes_the_mesh_device():
    mesh = meshlib.FetiMesh(0, 2, "cpu")
    config = FetiConfig(mesh=mesh)
    assert config.device == torch.device("cpu")
    assert config.replace(mesh=None).mesh is None
    assert config.replace(mesh=None).device == torch.device("cpu")
    with pytest.raises(TypeError, match="FetiMesh"):
        FetiConfig(mesh="data")
    with pytest.raises(ValueError, match="mesh's"):
        FetiConfig(mesh=mesh, device="meta")


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{world size: {case: [each rank's result]}} from one spawn per world
    size, and the plan-cache directory the ``schur="auto"`` case wrote."""
    cache = tmp_path_factory.mktemp("plans")
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(cache))
    out = {}
    try:
        for world, names in WORLDS.items():
            ranks = meshlib.spawn_ranks(
                sharded.solve_cases, world, backend="gloo", device="cpu",
                args=([_case(n) for n in names],))
            out[world] = {name: [r[i] for r in ranks]
                          for i, name in enumerate(names)}
    finally:
        mp.undo()
    return types.SimpleNamespace(results=out, cache=cache)


@pytest.fixture(scope="module")
def single():
    """{case: the port's single-device solution}."""
    out = {}
    for name, (prob, kw, n_rhs) in CASES.items():
        if kw.get("schur") == "auto":
            kw = dict(kw, plan_cache=False)
        out[name] = _solve_single(_problem(prob), _config(**kw), n_rhs)
    return out


def _reference():
    pytest.importorskip("jax")
    from repro.core import SchurAssemblyConfig as Config
    from repro.fem import decompose_problem as decompose
    from repro.feti import FetiConfig as FetiCfg
    from repro.feti import FetiSolver as Solver

    return types.SimpleNamespace(Config=Config, decompose=decompose,
                                 FetiConfig=FetiCfg, Solver=Solver)


# the cases held to the reference, each with the reference's modes whose
# counts it may take (ROADMAP C3: either, where they disagree)
REF_CASES = {"heat-explicit": ("explicit", "implicit"),
             "heat-implicit": ("implicit", "explicit"),
             "ela3d-dirichlet": ("explicit", "implicit"),
             "heat-many": ("explicit",)}


@pytest.fixture(scope="module")
def reference():
    """{(problem, preconditioner, n_rhs, mode): the reference's solution}."""
    ref = _reference()
    out = {}
    for name, modes in REF_CASES.items():
        prob, kw, n_rhs = CASES[name]
        precond = kw.get("preconditioner", "lumped")
        ref_prob = ref.decompose(*PROBLEMS[prob][1])
        for mode in modes:
            key = (prob, precond, n_rhs, mode)
            if key in out:
                continue
            solver = ref.Solver(ref_prob, ref.FetiConfig(
                schur=ref.Config(block_size=8, rhs_block_size=8),
                mode=mode, preconditioner=precond, plan_cache=False))
            out[key] = (
                solver.solve_many(ref_prob.load_cases(n_rhs, kind="sweep"))
                if n_rhs else solver.solve())
    return out


def _cases():
    return [(world, name) for world, names in WORLDS.items()
            for name in names]


@pytest.mark.parametrize("world,name", _cases())
def test_sharded_solve_matches_the_single_device_port(spawned, single,
                                                      world, name):
    ranks = spawned.results[world][name]
    want = single[name]
    sol = ranks[0]["solution"]
    assert [r["rank"] for r in ranks] == list(range(world))
    assert [tuple(r["owned"]) for r in ranks] == [
        (s.start, s.stop) for s in _slices(4, world)]
    for r in ranks:  # every rank returns the same solution
        assert np.array_equal(r["solution"].u_global, sol.u_global)
        assert np.array_equal(r["solution"].lam, sol.lam)
        assert np.array_equal(r["solution"].iterations, sol.iterations)
    assert np.all(sol.converged)
    assert np.abs(sol.u_global - want.u_global).max() <= U_TOL
    if world == 1:
        # one rank: bit-identical to mesh=None
        assert np.array_equal(sol.u_global, want.u_global)
        assert np.array_equal(sol.lam, want.lam)
        assert np.array_equal(sol.alpha, want.alpha)
    if name == "ela3d-dirichlet":
        # at tol 1e-9 this case stops at rounding level: the reference's
        # own modes take 52 and 53 (ROADMAP C3)
        assert np.asarray(sol.iterations).item() in (52, 53)
    else:
        assert np.array_equal(sol.iterations, want.iterations)
    assert sol.refine_outer == want.refine_outer
    pcpg = ranks[0]["pcpg_all_reduces"]
    iters = int(np.max(sol.iterations)) if name != "heat-f32" else None
    if iters is not None:
        # six a PCPG iteration and six for its start: the dual apply, the
        # preconditioner and two for each of the two projections
        assert pcpg == 6 * (iters + 1), (pcpg, iters)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_sharded_solve_matches_the_reference(spawned, reference, name):
    prob, kw, n_rhs = CASES[name]
    key = (prob, kw.get("preconditioner", "lumped"), n_rhs)
    modes = REF_CASES[name]
    for world in WORLDS:
        if name not in spawned.results[world]:
            continue
        sol = spawned.results[world][name][0]["solution"]
        want = reference[key + (modes[0],)]
        assert np.abs(sol.u_global - np.asarray(want.u_global)).max() \
            <= U_TOL
        # equal to the reference's, or where its explicit and implicit
        # modes disagree, either of their counts (ROADMAP C3)
        counts = [np.asarray(reference[key + (m,)].iterations).tolist()
                  for m in modes]
        assert np.asarray(sol.iterations).tolist() in counts, (
            world, sol.iterations, counts)


def test_auto_plans_once_for_every_rank(spawned):
    ranks = spawned.results[3]["heat-auto"]
    plans = [r["plans"] for r in ranks]
    assert plans[0] is not None and set(plans[0]) == {"dual"}
    assert all(p == plans[0] for p in plans)
    # rank 0 alone planned and wrote the cache: one joint entry
    assert len(list(spawned.cache.glob("graph-*.json"))) == 1


def test_rank_stacks_sum_to_the_single_device_bytes(spawned):
    for world in (2, 3):
        ranks = spawned.results[world]["ela3d-dirichlet"]
        prob = _problem("ela3d")
        st = preprocess_cluster(prob, _config(preconditioner="dirichlet"))
        one = st.device_bytes()
        for k in ("L", "K", "Btp", "F", "Sb", "Btb"):
            assert sum(r["device_bytes"][k] for r in ranks) == one[k], k


def test_a_failing_rank_ends_the_run():
    # rank 1's device cannot run the solve: it fails in preprocessing while
    # rank 0 waits in the coarse problem's all-reduce; the run must end
    # with the failure, not hang
    with pytest.raises(meshlib.RankFailure, match="rank 1 of 2"):
        meshlib.spawn_ranks(
            sharded.solve_cases, 2, backend="gloo", device="cpu",
            devices=["cpu", "meta"], timeout=60,
            args=([_case("heat-explicit")],))


@pytest.mark.parametrize("flags", [
    [],
    ["--precond", "dirichlet", "--storage", "packed"],
    ["--n-rhs", "4"],
])
def test_launcher_devices_validates_itself(capsys, flags):
    rc = solve_feti.main(["--smoke", "--device", "cpu", "--devices", "3",
                          "--backend", "gloo", "--kernels", "--validate",
                          *flags])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert sum(line.startswith("[feti] rank ") for line in out.splitlines()) \
        == 3
    assert "sharded vs single-device: max|Δu|=" in out
    assert "stack bytes sum to the single device's: True" in out


@pytest.mark.cuda
def test_two_gloo_ranks_share_one_card_with_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import build

    build.build()  # here, so the two ranks only load the libraries
    case = dict(arch="feti-heat-2d", smoke=True,
                config=dict(schur=SCHUR))
    ranks = [r[0] for r in meshlib.spawn_ranks(
        sharded.solve_cases, 2, backend="gloo", device="cuda",
        args=([case],))]
    prob = decompose_problem(*PROBLEMS["heat"][1])
    want = FetiSolver(prob, FetiConfig(schur=SCHUR)).solve()
    for r in ranks:
        assert r["device"] == "cuda:0"
        assert r["launches"] == {"stepped_trsm": {"f64": 1},
                                 "stepped_syrk": {"f64": 1}}
        sol = r["solution"]
        assert sol.iterations == want.iterations
        assert np.abs(sol.u_global - want.u_global).max() <= U_TOL
