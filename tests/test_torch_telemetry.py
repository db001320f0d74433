"""The port's solver telemetry against the reference's (``repro.obs`` and
``FetiSolver.report`` / ``amortization_report``).

Both packages solve the identical decompositions (the reference's host
arrays carried over with ``repro_torch.interop``) on the smoke
configurations: feti-heat-2d's (2, 2) x (4, 4) at bs 8, and
feti-elasticity-3d's smoke size with the lumped and the Dirichlet
preconditioner, through ``solve`` and ``solve_many``, in explicit and
implicit mode. What must agree:

* the span-name trees (names and nesting; the times are each package's
  own);
* ``report()``'s keys, its ``schema_version`` and the device bytes, stack
  by stack and in the gauges;
* the PCPG counters at ``tol=1e-9`` (where the reference's two modes stop an
  iteration apart, ROADMAP C3, either count is accepted);
* ``amortization_report`` on explicit timings (exactly, the analytic
  entries included) and its ``ValueError``;
* the analytic counts (``feti_solve_iter_counts``,
  ``block_cholesky_flops``), the ``pcpg.tol_clamp`` counter, and the
  validators' verdicts on the same artifacts;
* the launcher's ``--trace`` / ``--report`` on the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import SchurAssemblyConfig as RefConfig  # noqa: E402
from repro.fem import decompose_problem as ref_decompose  # noqa: E402
from repro.feti import FetiConfig as RefFetiConfig  # noqa: E402
from repro.feti import FetiSolver as RefSolver  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import validate as ref_validate  # noqa: E402

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver  # noqa: E402
from repro_torch.interop import SUBDOMAIN_KEYS, from_reference_problem  # noqa: E402
from repro_torch.obs import Tracer, metrics  # noqa: E402
from repro_torch.obs import validate  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-9
BS = 8
MODES = ("explicit", "implicit")
# case: (problem, dim, sub_grid, elems_per_sub, preconditioner, load cases;
# 0 for solve(), else solve_many() of that many)
CASES = {
    "heat2d": (("heat", 2, (2, 2), (4, 4)), "lumped", 0),
    "heat2d-many": (("heat", 2, (2, 2), (4, 4)), "lumped", 3),
    "ela3d": (("elasticity", 3, (2, 2, 1), (2, 2, 2)), "lumped", 0),
    "ela3d-dirichlet": (("elasticity", 3, (2, 2, 1), (2, 2, 2)), "dirichlet",
                        0),
}


def _carry(ref):
    return from_reference_problem(dict(
        subdomains=[{k: getattr(sd, k)
                     for k in SUBDOMAIN_KEYS + ("node_gids", "fixing_node")}
                    for sd in ref.subdomains],
        c=ref.c, n_lambda=ref.n_lambda, dirichlet_gids=ref.dirichlet_gids,
        coords=ref.global_mesh.coords, elems=ref.global_mesh.elems,
        dim=ref.dim, sub_grid=ref.sub_grid,
        elems_per_sub=ref.elems_per_sub, params=ref.params,
        problem=ref.problem, ndof_per_node=ref.ndof_per_node))


_PROBLEMS: dict = {}


def _problems(decomp):
    """(reference problem, port problem), decomposed once per module."""
    if decomp not in _PROBLEMS:
        ref = ref_decompose(*decomp)
        _PROBLEMS[decomp] = (ref, _carry(ref))
    return _PROBLEMS[decomp]


def _ref_solver(ref, mode, precond, **kw):
    return RefSolver(ref, RefFetiConfig(
        schur=RefConfig(block_size=BS, rhs_block_size=BS, storage="dense"),
        mode=mode, preconditioner=precond, plan_cache=False, **kw))


def _port_solver(prob, mode, precond, **kw):
    return FetiSolver(prob, FetiConfig(
        schur=SchurAssemblyConfig(block_size=BS, rhs_block_size=BS,
                                  use_kernels=True),
        mode=mode, preconditioner=precond, device="cpu", **kw))


def _names(tree):
    """The span tree without its times: [(name, [children...]), ...]."""
    return [(node["name"], _names(node["children"])) for node in tree]


def _run(solver, reg, prob, n_rhs):
    """Solve once on a fresh metrics registry; (solution, report)."""
    reg.reset()
    if n_rhs:
        sol = solver.solve_many(prob.load_cases(n_rhs, kind="sweep"), tol=TOL)
    else:
        sol = solver.solve(tol=TOL)
    return sol, solver.report()


@pytest.fixture(scope="module")
def runs():
    """Every case in both modes through both packages: {(case, mode):
    (port (solver, solution, report), reference (...))}."""
    out = {}
    for case, (decomp, precond, n_rhs) in CASES.items():
        ref, prob = _problems(decomp)
        for mode in MODES:
            rs = _ref_solver(ref, mode, precond)
            ps = _port_solver(prob, mode, precond)
            want = _run(rs, ref_metrics, ref, n_rhs)
            got = _run(ps, metrics, prob, n_rhs)
            out[case, mode] = ((ps, *got), (rs, *want))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_span_trees_match_reference(runs, case, mode):
    (_, _, got), (_, _, want) = runs[case, mode]
    assert _names(got["spans"]) == _names(want["spans"])
    names = [n for n, _ in _names(got["spans"])]
    assert names == ["preprocess", "solve"]
    # every child within its parent, every span closed
    def check(node):
        assert node["duration_s"] > 0
        for child in node["children"]:
            assert child["duration_s"] <= node["duration_s"]
            check(child)
    for root in got["spans"]:
        check(root)


@pytest.mark.parametrize("case", CASES)
def test_report_keys_and_device_bytes_match_reference(runs, case):
    (ps, _, got), (_, _, want) = runs[case, "explicit"]
    assert got["schema_version"] == want["schema_version"] == 1
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"])
    assert set(got["timings"]) == set(want["timings"])
    assert got["device_bytes"] == want["device_bytes"]

    def bytes_gauges(rep):
        return {k: v for k, v in rep["metrics"]["gauges"].items()
                if k.startswith("device_bytes")}

    assert bytes_gauges(got) == bytes_gauges(want)
    assert got["metrics"]["gauges"]["device_bytes_total"] == \
        ps.state.device_bytes()["total"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_pcpg_counters_match_reference(runs, case, mode):
    (_, sol, got), (_, _, want) = runs[case, mode]
    gc, wc = got["metrics"]["counters"], want["metrics"]["counters"]
    assert gc["pcpg.solves"] == wc["pcpg.solves"]
    n_iter = np.sum(sol.iterations)
    assert gc["pcpg.iterations"] == n_iter
    # ROADMAP C3: the reference's explicit and implicit modes may stop an
    # iteration apart at this tolerance; either of its counts is accepted
    other = runs[case, MODES[1 - MODES.index(mode)]][1][2]
    assert gc["pcpg.iterations"] in (
        wc["pcpg.iterations"],
        other["metrics"]["counters"]["pcpg.iterations"])
    pcpg = [c for root in got["spans"] for c in root["children"]
            if c["name"] == "pcpg"]
    assert len(pcpg) == 1
    key = "block_iterations" if CASES[case][2] else "iterations"
    assert pcpg[0]["attrs"][key] == (sol.block_iterations if CASES[case][2]
                                     else sol.iterations)


def _amortization_pair(case, **kw):
    decomp, precond, _ = CASES[case]
    ref, prob = _problems(decomp)
    rs = _ref_solver(ref, "explicit", precond)
    ps = _port_solver(prob, "explicit", precond)
    rs.preprocess()
    ps.preprocess()
    return ps.amortization_report(**kw), rs.amortization_report(**kw)


@pytest.mark.parametrize("case,dirichlet_s,want_iters", [
    ("heat2d", None, 10.0), ("ela3d-dirichlet", 0.5, 15.0)])
def test_amortization_report_matches_reference(case, dirichlet_s,
                                               want_iters):
    got, want = _amortization_pair(
        case, t_assembly_s=1.0, t_implicit_iter_s=0.15,
        t_explicit_iter_s=0.05, t_dirichlet_s=dirichlet_s)
    assert got["amortization_iterations"] == pytest.approx(want_iters)
    assert got["amortization_iterations"] == want["amortization_iterations"]
    assert set(got) == set(want)
    for key in ("amortization_solves", "n_rhs", "assembly_s", "dirichlet_s",
                "implicit_iter_s", "explicit_iter_s",
                "assembly_flops_per_subdomain", "solve_iter_counts",
                "measured_from"):
        assert got[key] == want[key], key
    d_got, d_want = (got["dirichlet_flops_per_subdomain"],
                     want["dirichlet_flops_per_subdomain"])
    if dirichlet_s is None:
        assert d_got is None and d_want is None
    else:
        assert d_got == d_want and d_got["total"] > 0
        assert d_got["cholesky_ii"] == 0  # elasticity shares the factor
        assert d_got["cholesky_ii_saved_by_sharing"] > 0


def test_amortization_report_infers_from_spans_and_names_what_is_missing():
    """After an explicit solve the assembly and explicit per-iteration
    times come from the spans; the implicit one must be passed, and both
    packages' errors name it."""
    ref, prob = _problems(CASES["heat2d"][0])
    reports = []
    for solver in (_port_solver(prob, "explicit", "lumped"),
                   _ref_solver(ref, "explicit", "lumped")):
        solver.solve(tol=TOL)
        with pytest.raises(ValueError, match="t_implicit_iter_s"):
            solver.amortization_report()
        rep = solver.amortization_report(t_implicit_iter_s=1.0)
        assert rep["measured_from"] == {"assembly_s": "span:stage:dual",
                                        "explicit_iter_s": "span:pcpg"}
        tr = solver.telemetry.tracer
        assert rep["assembly_s"] == tr.last("stage:dual").duration
        pcpg = tr.last("pcpg")
        assert rep["explicit_iter_s"] == pytest.approx(
            pcpg.duration / pcpg.attrs["iterations"])
        reports.append(rep)
    assert reports[0]["solve_iter_counts"] == reports[1]["solve_iter_counts"]


def _ref_analytic():
    from repro.launch import analytic
    from repro.sparse.cholesky import block_cholesky_flops

    return analytic, block_cholesky_flops


def _mask(nb, seed):
    rng = np.random.default_rng(seed)
    m = np.tril(rng.random((nb, nb)) < 0.5)
    np.fill_diagonal(m, True)
    return m


@pytest.mark.parametrize("fn,args", [
    ("iter", (4, 14, 1, 8)),
    ("iter", (64, 258, 16, 8)),
    ("iter", (64, 258, 64, 4)),
    ("iter", (27, 100, 3, 2)),
    ("iter", (1, 1, 0, 8)),  # n_rhs < 1 raises in both
    ("chol", (100, 16, None)),
    ("chol", (100, 16, 7)),
    ("chol", (4225, 128, None)),
    ("chol", (4225, 128, 3)),
    ("chol", (61, 8, 5)),
])
def test_analytic_counts_match_reference(fn, args):
    from repro_torch.launch import FETI_SOLVE_N_RHS, feti_solve_iter_counts
    from repro_torch.sparse import block_cholesky_flops

    analytic, ref_chol = _ref_analytic()
    assert FETI_SOLVE_N_RHS == analytic.FETI_SOLVE_N_RHS
    if fn == "iter":
        S, m, r, fb = args
        if r < 1:
            for f in (feti_solve_iter_counts, analytic.feti_solve_iter_counts):
                with pytest.raises(ValueError, match="n_rhs"):
                    f(S, m, n_rhs=r, fb=fb)
            return
        assert feti_solve_iter_counts(S, m, n_rhs=r, fb=fb) == \
            analytic.feti_solve_iter_counts(S, m, n_rhs=r, fb=fb)
    else:
        n, bs, seed = args
        mask = None if seed is None else _mask(-(-n // bs), seed)
        got = block_cholesky_flops(n, bs, mask)
        assert got == ref_chol(n, bs, mask) and got > 0


def test_tol_clamp_counter_matches_reference():
    """One f32 solve (no refinement) asked for a tol below the f32 floor
    clamps once in both packages."""
    from repro.feti.pcpg import reset_tol_clamp_warnings as ref_rearm

    from repro_torch.feti.pcpg import reset_tol_clamp_warnings

    ref, prob = _problems(CASES["heat2d"][0])
    for solver, reg, rearm in (
            (_port_solver(prob, "explicit", "lumped", dtype="f32", refine=0),
             metrics, reset_tol_clamp_warnings),
            (_ref_solver(ref, "explicit", "lumped", dtype="f32", refine=0),
             ref_metrics, ref_rearm)):
        solver.preprocess()
        reg.reset()
        rearm()
        with pytest.warns(RuntimeWarning, match="clamping"):
            solver.solve(tol=1e-9)
        assert reg.get("pcpg.tol_clamp", dtype="f32") == 1
        assert reg.get("pcpg.tol_clamp", dtype="f64") == 0


def _sample_tracer():
    tr = Tracer()
    with tr.span("solve"):
        with tr.span("pcpg", iterations=3):
            pass
    return tr


def _artifacts(root):
    """The artifacts of the reference's validator tests, by name."""
    tr = _sample_tracer()
    tr.to_jsonl(str(root / "spans.jsonl"))
    tr.to_chrome_trace(str(root / "trace.json"),
                       metrics={"counters": {"a": 1}})
    (root / "bad.json").write_text(json.dumps(
        {"traceEvents": [{"name": "x", "ph": "B", "ts": -1}]}))
    (root / "bad.jsonl").write_text('{"ok": 1}\nnot json\n')
    (root / "good.jsonl").write_text('{"schema_version": 1}\n')
    (root / "empty.jsonl").write_text("\n")
    (root / "list.json").write_text("[1, 2]")
    (root / "noevents.json").write_text(json.dumps(
        {"schema_version": 1, "metrics": {}, "traceEvents": []}))
    (root / "badev.json").write_text(json.dumps(
        {"schema_version": 1, "metrics": {}, "traceEvents": [
            1, {"name": 2, "ph": "X", "ts": "a", "dur": -1, "pid": 1,
                "tid": 1}]}))
    (root / "broken.json").write_text("{")


# the artifacts _artifacts writes, and one that does not exist
ARTIFACTS = ["spans.jsonl", "trace.json", "bad.json", "bad.jsonl",
             "good.jsonl", "empty.jsonl", "list.json", "noevents.json",
             "badev.json", "broken.json", "missing.json"]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_validator_verdicts_match_reference(tmp_path, name, capsys):
    _artifacts(tmp_path)
    path = str(tmp_path / name)
    got, want = validate.validate(path), ref_validate.validate(path)
    assert got == want
    assert (got == []) == (name in ("spans.jsonl", "trace.json",
                                    "good.jsonl"))
    assert validate.main([path]) == ref_validate.main([path])
    assert validate.main([]) == ref_validate.main([]) == 2


def test_launcher_trace_and_report_cpu(tmp_path, capsys):
    """``--trace`` writes a trace both validators accept, with the metrics
    embedded and the reference's span names; ``--report`` prints the
    report, whose device-byte total is the launcher's printout."""
    from repro_torch.launch import solve_feti

    path = tmp_path / "trace.json"
    rc = solve_feti.main(["--arch", "feti-heat-2d", "--smoke", "--device",
                          "cpu", "--kernels", "--trace", str(path),
                          "--report"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"[feti] telemetry trace -> {path}" in out
    assert validate.main([str(path)]) == 0
    assert ref_validate.main([str(path)]) == 0
    doc = json.loads(path.read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert names == ["preprocess", "init", "prep", "stage:dual", "pack",
                     "solve", "rhs_setup", "pcpg", "recover"]
    assert doc["metrics"]["counters"]["pcpg.solves"] >= 1
    solve = doc["traceEvents"][names.index("solve")]
    assert len(solve["args"]["residual_history"]) == \
        solve["args"]["iterations"]
    start = out.index("\n{") + 1
    rep = json.JSONDecoder().raw_decode(out[start:])[0]
    assert rep["schema_version"] == 1
    total = int(out.split(" total=")[1].split()[0].replace(",", ""))
    assert rep["device_bytes"]["total"] == total
