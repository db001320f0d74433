"""The port's mixed-precision path (f32 and bf16 storage with refinement)
against the reference.

Both packages get the identical decomposition (the reference's host arrays
carried over with ``repro_torch.interop``). The reference's Pallas calls do
not run here: it assembles with its default factor-split/input-split
variants, as its own precision tests do; the port runs its kernel path
(the kernels' plain versions on the CPU, at f32 as on the card).

* The precision helpers, ``_clamp_tol``, ``_safe_denom`` and the coarse
  factor's rank floor equal the reference's at f64, f32 and bf16.
* The f32 L, F̃ and S_b stacks are within 1e-4 relative (max-abs over
  max-abs) of the reference's f32 stacks, dense and packed, at bs = 8 and
  32: both round their own f32 sums, in another order.
* f32 refined solves (explicit with defect-correction outers, implicit,
  Dirichlet) come within 1e-8 of the scipy oracle at tol 1e-10, with the
  reference's ``refine_outer`` and total PCPG iterations within one per
  PCPG run of the reference's (ROADMAP C3 at the f32 floor).
* bf16 storage comes within 1e-2 of the oracle at tol 1e-6 (the refined
  operators are only as accurate as κ·eps_bf16 lets them be).
* f64 is unchanged: ``refine=None`` and ``refine=0`` give bit-identical
  ``lam``, and so does ``history=True``.
"""
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver, preprocess_cluster  # noqa: E402
from repro_torch.feti.pcpg import TolClampState, _clamp_tol, _safe_denom  # noqa: E402
from repro_torch.feti.dirichlet import assemble_dirichlet_schur  # noqa: E402
from repro_torch.feti.projector import coarse_factor, coarse_floor_factor  # noqa: E402
from repro_torch.interop import from_reference_packed  # noqa: E402
from repro_torch.launch import solve_feti  # noqa: E402
from repro_torch.sparse import PackedBlocks  # noqa: E402

from test_torch_dirichlet import _carry  # noqa: E402

pytestmark = pytest.mark.torch_port

DTYPES = ("f64", "f32", "bf16")
STACK_TOL = 1e-4  # f32 stacks of the two packages: f32 sums in two orders
ORACLE_TOL = 1e-8  # the reference's own accuracy contract for f32 + refine
SOLVE_TOL = 1e-10


def _reference():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import ml_dtypes

    import repro.core.precision as prec
    from repro.core import SchurAssemblyConfig as Config
    from repro.fem import decompose_problem
    from repro.feti import FetiConfig as FetiCfg
    from repro.feti import FetiSolver as Solver
    from repro.feti import preprocess_cluster as preprocess
    from repro.feti.pcpg import TolClampState, _clamp_tol, _safe_denom
    from repro.feti.projector import coarse_factor as ref_coarse_factor

    return types.SimpleNamespace(
        jnp=jnp, bf16=ml_dtypes.bfloat16, prec=prec, Config=Config,
        decompose=decompose_problem, FetiConfig=FetiCfg, Solver=Solver,
        preprocess=preprocess, TolClampState=TolClampState,
        clamp_tol=_clamp_tol, safe_denom=_safe_denom,
        coarse_factor=ref_coarse_factor)


def _rel(got, want):
    got, want = (np.asarray(x, dtype=np.float64) for x in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _values(x):
    return x.values if isinstance(x, PackedBlocks) else x


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
def test_precision_helpers_match_reference(name):
    ref = _reference()
    rp = ref.prec
    td = precision.canonical_dtype(name)
    assert precision.dtype_name(td) == rp.dtype_name(name) == name
    assert (precision.dtype_name(precision.compute_dtype(name))
            == rp.dtype_name(rp.compute_dtype(name)))
    for steps in (0, 2):
        assert (precision.dtype_name(precision.solve_dtype(name, steps))
                == rp.dtype_name(rp.solve_dtype(name, steps)))
    assert precision.eps(name) == rp.eps(name)
    assert precision.itemsize(name) == rp.itemsize(name)
    assert precision.tol_floor(name) == rp.tol_floor(name)
    assert precision.default_refine_steps(name) == rp.default_refine_steps(name)
    # the coarse factor's rank floor: max(1e-12, (1e3·eps)²), exactly 1e-12
    # at f64
    want = max(1e-12, float(ref.jnp.finfo(rp.canonical_dtype(name)).eps
                            * 1e3) ** 2)
    assert coarse_floor_factor(td) == want
    if name == "f64":
        assert coarse_floor_factor(td) == 1e-12
    # the spellings the config takes
    assert precision.canonical_dtype(td) is td
    with pytest.raises(ValueError, match="unsupported"):
        precision.canonical_dtype("f16")


@pytest.mark.parametrize("name", DTYPES)
def test_clamp_tol_and_safe_denom_match_reference(name):
    ref = _reference()
    rdt = ref.prec.canonical_dtype(name)
    td = precision.canonical_dtype(name)
    for tol in (1e-3, 1e-6, 1e-9, 1e-13, 1e-16):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = ref.clamp_tol(tol, rdt, ref.TolClampState())
            got = _clamp_tol(tol, td, TolClampState())
        assert got == want, (name, tol)
    # the warning fires once per dtype and state
    state = TolClampState()
    floor = precision.tol_floor(name)
    with pytest.warns(RuntimeWarning, match="attainable floor"):
        _clamp_tol(floor / 10, td, state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _clamp_tol(floor / 10, td, state)
    tiny = float(torch.finfo(td).tiny)
    vals = np.array([tiny / 8, 0.0, -0.0, 2.0, -3.0, tiny, -tiny, -1e-3])
    want = ref.safe_denom(ref.jnp.asarray(vals, dtype=rdt))
    got = _safe_denom(torch.as_tensor(vals).to(td))
    assert got.dtype == td
    np.testing.assert_array_equal(got.double().numpy(),
                                  np.asarray(want, dtype=np.float64))
    assert torch.all(got.abs() >= tiny)
    # a negative subnormal keeps its sign here; XLA on the CPU flushes it
    # to -0 before the reference's sign test, so it is held apart
    neg = _safe_denom(torch.tensor([-tiny / 8], dtype=torch.float64).to(td))
    assert neg.item() == -tiny


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_coarse_factor_matches_reference(name):
    """An exactly dependent column gets the dtype's floored pivot; the
    healthy ones pass through (the reference's QR has no bf16)."""
    ref = _reference()
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 3))
    G = np.concatenate([A, A[:, :1]], axis=1)
    td = precision.canonical_dtype(name)
    got = coarse_factor(torch.as_tensor(G).to(td))
    want = np.asarray(ref.coarse_factor(
        ref.jnp.asarray(G, dtype=ref.prec.canonical_dtype(name))))
    assert got.dtype == td
    tol = 1e-12 if name == "f64" else 1e-5
    assert _rel(got.numpy(), want) <= tol
    col_scale = np.sqrt((G * G).sum() / G.shape[1])
    assert abs(got[3, 3].item()) >= np.sqrt(coarse_floor_factor(td)) \
        * col_scale * (1 - 1e-6)


# ---------------------------------------------------------------------------
# the kernels at f32
# ---------------------------------------------------------------------------

KERNEL_TOL = 1e-5  # f32 kernels of the two packages: f32 sums in two orders


@pytest.mark.parametrize("n,m,bs,bm", [(61, 30, 8, 8), (64, 40, 16, 8),
                                       (96, 44, 16, 16)])
def test_plain_f32_kernels_match_reference(n, m, bs, bm):
    """The stepped TRSM (dense and packed factor) and SYRK at f32, their
    plain versions here, against the reference's Pallas kernels in
    interpret mode at f32 on the same seeded f32 operands; both invert the
    diagonal blocks and accumulate in f32."""
    from test_torch_fused import _case

    from repro_torch.kernels import ops

    ref = _reference()
    from repro.core import build_stepped_meta as ref_meta
    from repro.kernels import ops as ref_ops
    from repro.sparse import packed as ref_packed

    S = 2
    L, pb, B, meta = _case(n, m, bs, bm, S, 4, seed=n + bs)
    L, pb, B = L.float(), pb.to(torch.float32), B.float()
    Y = ops.stepped_trsm(L, B, meta)
    Yp = ops.stepped_trsm_packed(pb, B, meta)
    F = ops.stepped_syrk(Y, meta)
    assert Y.dtype == Yp.dtype == F.dtype == torch.float32
    rmeta = ref_meta(B[0].numpy() != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    ref_index = ref_packed.PackedBlockIndex.from_mask(pb.index.mask, n, bs)
    jnp = ref.jnp
    for s in range(S):
        Bs = jnp.asarray(B[s].numpy())
        want = ref_ops.stepped_trsm(jnp.asarray(L[s].numpy()), Bs, rmeta,
                                    interpret=True)
        assert want.dtype == jnp.float32
        assert _rel(Y[s].numpy(), want) <= KERNEL_TOL
        want_p = ref_ops.stepped_trsm_packed(
            ref_packed.PackedBlocks(jnp.asarray(pb.values[s].numpy()),
                                    ref_index), Bs, rmeta, interpret=True)
        assert _rel(Yp[s].numpy(), want_p) <= KERNEL_TOL
        want_f = ref_ops.stepped_syrk(jnp.asarray(Y[s].numpy()), rmeta,
                                      interpret=True)
        assert want_f.dtype == jnp.float32
        assert _rel(F[s].numpy(), want_f) <= KERNEL_TOL


def test_fused_kernels_run_f32():
    """The fused wrappers take f32 operands (the f32 kernels on the card):
    on the CPU their plain versions give the unfused f32 pair's F, at f32,
    and launch nothing. (tests/test_torch_f32.py holds them against the
    reference.)"""
    from test_torch_fused import _case

    from repro_torch.kernels import (
        ops,
        stepped_trsm_syrk_kernel,
        stepped_trsm_syrk_packed_kernel,
    )

    L, pb, B, meta = _case(61, 30, 8, 8, 2, 0, seed=1)
    before = (stepped_trsm_syrk_kernel.launches,
              stepped_trsm_syrk_packed_kernel.launches)
    for fac, trsm in ((L.float(), ops.stepped_trsm),
                      (pb.to(torch.float32), ops.stepped_trsm_packed)):
        F = ops.stepped_trsm_syrk(fac, B.float(), meta)
        assert F.dtype == torch.float32
        assert torch.equal(F, ops.stepped_syrk(trsm(fac, B.float(), meta),
                                               meta))
    assert (stepped_trsm_syrk_kernel.launches,
            stepped_trsm_syrk_packed_kernel.launches) == before


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ela():
    """The port and reference copies of one elasticity decomposition (its
    Dirichlet stage shares the interior factor)."""
    ref = _reference()
    ref_prob = ref.decompose("elasticity", 2, (2, 2), (4, 4))
    return types.SimpleNamespace(ref=ref, ref_prob=ref_prob,
                                 prob=_carry(ref_prob))


@pytest.mark.parametrize("bs", [8, 32])
@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_f32_stacks_match_reference(ela, storage, bs):
    ref = ela.ref
    fields = dict(block_size=bs, rhs_block_size=bs, storage=storage)
    want = ref.preprocess(ela.ref_prob, ref.FetiConfig(
        schur=ref.Config(**fields), preconditioner="dirichlet", dtype="f32",
        plan_cache=False))
    got = preprocess_cluster(ela.prob, FetiConfig(
        schur=SchurAssemblyConfig(use_kernels=True, **fields),
        preconditioner="dirichlet", dtype="f32", device="cpu"))
    assert got.storage == storage
    for name in ("L", "K", "F", "Sb", "Btp", "Btb"):
        assert _values(getattr(got, name)).dtype == torch.float32, name
    for name in ("f", "fp", "R"):
        assert getattr(got, name).dtype == torch.float64, name
    assert got.Kreg.values.dtype == torch.float64 and got.refine_steps == 2
    if storage == "packed":
        L = from_reference_packed(np.asarray(want.L.values),
                                  np.asarray(want.L.index.mask), got.index.n,
                                  bs, dtype=torch.float32)
        assert L.values.dtype == torch.float32
        assert _rel(got.L.values, L.values) <= STACK_TOL
    else:
        assert _rel(got.L, want.L) <= STACK_TOL
    assert _rel(got.F, want.F) <= STACK_TOL
    assert _rel(got.Sb, want.Sb) <= STACK_TOL
    # the refinement matrix is the f64 regularized K itself (the padded
    # diagonal tail of a packed working stack, outside the matrix, may
    # differ)
    want_reg = from_reference_packed(np.asarray(want.Kreg.values),
                                     np.asarray(want.Kreg.index.mask),
                                     got.index.n, bs)
    assert _rel(got.Kreg.unpack(), want_reg.unpack()) <= 1e-14


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_reduced_stacks_are_the_f64_stacks_rounded(ela, storage, dtype):
    """Each subdomain's K is regularized, permuted and packed at f64 and
    rounded to the storage dtype as it lands: the working stack (held at
    the compute dtype), the lumped K and the Dirichlet blocks equal the f64
    stacks rounded, bit for bit, and K_reg is the f64 working stack."""
    from repro_torch.feti import dirichlet as dirlib
    from repro_torch.feti.assembly import (
        _device_stiffness,
        make_cluster_preprocessor,
    )

    sdt = precision.canonical_dtype(dtype)
    cdt = precision.compute_dtype(sdt)
    cpu = torch.device("cpu")
    static, _ = make_cluster_preprocessor(ela.prob, FetiConfig(
        schur=SchurAssemblyConfig(block_size=8, rhs_block_size=8),
        storage=storage, preconditioner="dirichlet", share_factor=False,
        device="cpu"))

    def stacks(storage_dtype, keep_reg):
        blocks = dirlib.DirichletBlocks(
            static["split"], ela.prob.n_subdomains, cpu, interior=True,
            index_ii=static["dirichlet_index"], storage=storage_dtype)
        out = _device_stiffness(
            ela.prob, static["node_perm"], static["index"], cpu,
            packed=storage == "packed", blocks=blocks, keep_reg=keep_reg,
            storage=storage_dtype)
        return out, blocks

    (W64, K64, none), b64 = stacks(torch.float64, False)
    (W, K, Kreg), b = stacks(sdt, True)
    assert none is None
    assert _values(W).dtype == cdt and K.values.dtype == sdt
    assert torch.equal(_values(W), _values(W64).to(sdt).to(cdt))
    assert torch.equal(K.values, K64.values.to(sdt))
    assert Kreg.values.dtype == torch.float64
    assert torch.equal(Kreg.values, W64.values if storage == "packed" else
                       static["index"].pack(W64, diag_identity_pad=True))
    for name in ("Kib", "Kbb", "Kii"):
        got, want = (_values(getattr(x, name)) for x in (b, b64))
        assert got.dtype == cdt, name
        assert torch.equal(got, want.to(sdt).to(cdt)), name


def test_f32_operator_error_against_the_reference():
    """ROADMAP C6: how far each package's f32 F̃ lands from the f64 one.
    Both run the same block Cholesky and assembly at f32; the port's
    factorization takes each step at f64 on its f32-stored blocks, which
    puts its factor at the reference's distance from f64
    (tests/test_torch_f32.py). Here, at 16 x 16 elements a subdomain, the
    port's F̃ stays within 1.5x of the reference's distance (1.18x; it was
    within 3x before the factorization's f64 steps)."""
    ref = _reference()
    ref_prob = ref.decompose("heat", 2, (2, 2), (16, 16))
    prob = _carry(ref_prob)
    fields = dict(block_size=16, rhs_block_size=16)
    want = {dt: np.asarray(ref.preprocess(ref_prob, ref.FetiConfig(
        schur=ref.Config(**fields), dtype=dt, plan_cache=False)).F)
        for dt in ("f64", "f32")}
    got = {dt: preprocess_cluster(prob, FetiConfig(
        schur=SchurAssemblyConfig(use_kernels=True, **fields), dtype=dt,
        device="cpu")).F.double().numpy() for dt in ("f64", "f32")}
    assert _rel(got["f64"], want["f64"]) <= 1e-12
    ref_err = _rel(want["f32"], want["f64"])
    port_err = _rel(got["f32"], want["f64"])
    rounding = _rel(want["f64"].astype(np.float32), want["f64"])
    assert 10 * rounding < ref_err  # the f32 arithmetic's, not rounding's
    assert port_err <= 1.5 * ref_err


def test_f32_halves_the_stacks(ela):
    """Factor, F̃, K and B̃ᵀ at f32 take exactly half of f64's bytes (the
    f64 K_reg of refinement comes on top); bf16 a quarter."""
    cfg = SchurAssemblyConfig(block_size=8, rhs_block_size=8,
                              use_kernels=True, storage="packed")
    by = {dt: preprocess_cluster(ela.prob, FetiConfig(
        schur=cfg, dtype=dt, device="cpu")).device_bytes() for dt in DTYPES}
    for name in ("L", "K", "Btp", "F"):
        assert by["f32"][name] * 2 == by["f64"][name], name
        assert by["bf16"][name] * 4 == by["f64"][name], name
    assert by["f64"]["Kreg"] == 0
    assert by["f32"]["Kreg"] == by["bf16"]["Kreg"] == by["f64"]["K"]


def test_dirichlet_schur_dtype_honored(ela):
    cfg = SchurAssemblyConfig(block_size=8, rhs_block_size=8)
    Sb64, _, _ = assemble_dirichlet_schur(ela.prob, cfg, device="cpu")
    assert Sb64.dtype == torch.float64
    Sb32, Btb32, _ = assemble_dirichlet_schur(ela.prob, cfg, device="cpu",
                                              dtype="f32")
    assert Sb32.dtype == Btb32.dtype == torch.float32
    assert _rel(Sb32, Sb64) <= STACK_TOL
    from repro.feti.dirichlet import assemble_dirichlet_schur as ref_one_shot

    want, _, _ = ref_one_shot(ela.ref_prob,
                              ela.ref.Config(block_size=8, rhs_block_size=8),
                              dtype="f32")
    assert np.asarray(want).dtype == np.float32
    assert _rel(Sb32, want) <= STACK_TOL


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heat():
    ref = _reference()
    ref_prob = ref.decompose("heat", 2, (2, 2), (4, 4))
    prob = _carry(ref_prob)
    return types.SimpleNamespace(ref=ref, ref_prob=ref_prob, prob=prob,
                                 u_ref=prob.reference_solution())


def _port_config(mode="explicit", preconditioner="lumped", **kw):
    return FetiConfig(schur=SchurAssemblyConfig(block_size=8, rhs_block_size=8,
                                                use_kernels=True),
                      mode=mode, preconditioner=preconditioner,
                      device="cpu", **kw)


def _oracle_err(u, u_ref):
    return np.abs(u - u_ref).max() / np.abs(u_ref).max()


@pytest.mark.parametrize("mode,preconditioner", [
    ("explicit", "lumped"), ("implicit", "lumped"),
    ("explicit", "dirichlet")])
def test_f32_refined_solves_match_oracle_and_reference(heat, mode,
                                                       preconditioner):
    ref = heat.ref
    want = ref.Solver(heat.ref_prob, ref.FetiConfig(
        schur=ref.Config(block_size=8, rhs_block_size=8), mode=mode,
        preconditioner=preconditioner, dtype="f32", plan_cache=False)
    ).solve(tol=SOLVE_TOL)
    got = FetiSolver(heat.prob, _port_config(
        mode, preconditioner, dtype="f32")).solve(tol=SOLVE_TOL)
    assert want.converged and got.converged
    assert _oracle_err(got.u_global, heat.u_ref) <= ORACLE_TOL
    assert (got.storage_dtype, got.compute_dtype, got.solve_dtype) == (
        "f32", "f32", "f64")
    assert got.refine_outer == want.refine_outer
    if mode == "explicit":
        assert got.refine_outer >= 1  # the outers engaged
    assert abs(got.iterations - want.iterations) <= got.refine_outer + 1


def test_bf16_smoke_solve_lands_near_the_oracle(heat):
    got = FetiSolver(heat.prob, _port_config(dtype="bf16")).solve(
        tol=1e-6, max_iter=500)
    assert (got.storage_dtype, got.compute_dtype, got.solve_dtype) == (
        "bf16", "f32", "f64")
    assert np.all(np.isfinite(got.u_global))
    assert _oracle_err(got.u_global, heat.u_ref) <= 1e-2


def test_f64_unchanged_by_refine_and_history(heat):
    runs = [FetiSolver(heat.prob, _port_config(**kw)).solve(
        tol=SOLVE_TOL, history=hist)
            for kw, hist in ((dict(), False), (dict(dtype="f64", refine=0),
                                               False), (dict(), True))]
    for sol in runs[1:]:
        np.testing.assert_array_equal(sol.lam, runs[0].lam)
        np.testing.assert_array_equal(sol.u_global, runs[0].u_global)
        assert sol.iterations == runs[0].iterations
        assert sol.refine_outer == 0
    assert runs[0].residual_history is None
    hist = runs[2].residual_history
    assert len(hist) == runs[2].iterations
    assert hist[-1] == runs[2].residual


def test_history_concatenates_the_outers(heat):
    """f32 explicit: one ‖P r‖ per PCPG iteration over every outer, and
    the same multipliers as without the record."""
    cfg = _port_config(dtype="f32")
    plain = FetiSolver(heat.prob, cfg).solve(tol=SOLVE_TOL)
    rec = FetiSolver(heat.prob, cfg).solve(tol=SOLVE_TOL, history=True)
    np.testing.assert_array_equal(rec.lam, plain.lam)
    assert rec.refine_outer >= 1
    assert len(rec.residual_history) == rec.iterations


def test_config_validates_the_precision_axis():
    assert FetiConfig(dtype="f32").solve_dtype == torch.float64
    assert FetiConfig(dtype="f32", refine=0).solve_dtype == torch.float32
    assert FetiConfig(dtype=torch.float64, refine=3).resolved_refine() == 0
    with pytest.raises(ValueError, match="refine"):
        FetiConfig(dtype="f32", refine=-1)
    with pytest.raises(ValueError, match="unsupported"):
        FetiConfig(dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 storage needs refine"):
        FetiConfig(dtype="bf16", refine=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_launcher_cpu_smoke_reduced(dtype, capsys):
    tol = "1e-6" if dtype == "bf16" else "1e-9"
    rc = solve_feti.main(["--arch", "feti-heat-2d", "--smoke", "--device",
                          "cpu", "--kernels", "--dtype", dtype, "--tol", tol,
                          "--validate"])
    out = capsys.readouterr().out
    assert f"dtype: storage={dtype} compute=f32 solve=f64 refine=2" in out
    err = float(out.split("rel err vs global solve: ")[1].split()[0])
    if dtype == "f32":
        assert rc == 0 and "converged=True" in out, out
        assert "refine_outer=1" in out
    else:
        # the bf16 floor (0.39) caps each outer's gain: the eight outers
        # stop short of 1e-6, as the reference's do, near the oracle
        assert err <= 1e-2
