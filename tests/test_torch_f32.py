"""The port's f32 factorization (ROADMAP C6) and its f32 fused TRSM→SYRK
path against the reference.

* C6: the reference's own f64 regularized K (in its factor order, from its
  host symbolic phase) rounded to f32 goes through the reference's block
  Cholesky (jit, CPU) and the port's, dense and packed. Each f32 factor's
  distance from the reference's f64 factor (max-abs over max-abs) is held
  to within 1.5x of the reference's: both run the same algorithm, and the
  port's f64 steps on f32-stored blocks put it at the reference's level.
  The f64 factor is the reference's within rounding (1e-13).
* The f32 fused plain versions (dense and packed factor) against the
  reference's unfused f32 Pallas pair in interpret mode and the plain
  oracles of ``repro/kernels/ref.py`` (the reference's fused kernels do not
  run on the installed jax, ROADMAP C1): 1e-5 relative, f32 sums in
  another order.
* f32 and bf16 preprocessing with ``fused=True`` against the reference's
  F̃ at the same dtype (the reference's default variants), dense and
  packed: 1e-4 relative, as the unfused f32 stacks are held in
  ``test_torch_precision.py``.
* An f32 fused explicit solve and a bf16 one against the scipy oracle.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver, preprocess_cluster  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    PackedBlockIndex,
    block_cholesky,
    block_cholesky_packed,
)

from test_torch_dirichlet import _carry  # noqa: E402

pytestmark = pytest.mark.torch_port

C6_RATIO = 1.5  # the port's f32 factor distance over the reference's
KERNEL_TOL = 1e-5  # f32 kernels of the two packages: f32 sums in two orders
STACK_TOL = 1e-4  # f32 F̃ of the two packages: f32 sums in two orders


def _reference():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import SchurAssemblyConfig as Config
    from repro.fem import decompose_problem
    from repro.fem.regularization import fixing_dofs_regularization
    from repro.feti import FetiConfig as FetiCfg
    from repro.feti import preprocess_cluster as preprocess
    from repro.feti.assembly import make_cluster_preprocessor
    from repro.sparse.cholesky import block_cholesky as ref_cholesky

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Config=Config, decompose=decompose_problem,
        regularize=fixing_dofs_regularization, FetiConfig=FetiCfg,
        preprocess=preprocess, static=make_cluster_preprocessor,
        cholesky=ref_cholesky)


def _rel(got, want):
    got, want = (np.asarray(x, dtype=np.float64) for x in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ---------------------------------------------------------------------------
# C6: the f32 factor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def c6():
    """The reference's regularized K at (2, 2) x (32, 32), bs 16, in its
    factor order, its block fill mask, and the reference's f64 and f32
    factors of it."""
    ref = _reference()
    bs = 16
    prob = ref.decompose("heat", 2, (2, 2), (32, 32))
    static, _ = ref.static(prob, ref.FetiConfig(
        schur=ref.Config(block_size=bs, rhs_block_size=bs),
        plan_cache=False))
    perm, mask = static["node_perm"], np.asarray(static["block_mask"])
    K = np.stack([ref.regularize(sd.K, sd.fixing_dofs)
                  for sd in prob.subdomains])[:, perm][:, :, perm]
    factor = ref.jax.jit(ref.jax.vmap(
        lambda A: ref.cholesky(A, bs, mask=mask)))
    L64 = np.asarray(factor(ref.jnp.asarray(K)))
    L32 = np.asarray(factor(ref.jnp.asarray(K.astype(np.float32))))
    assert L32.dtype == np.float32
    return types.SimpleNamespace(K=K, mask=mask, bs=bs, L64=L64,
                                 ref_err=_rel(np.tril(L32), L64))


@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_f32_factor_as_accurate_as_the_reference(c6, storage):
    """ROADMAP C6: the port's f32 factor lies no further from the f64
    factor than 1.5x the reference's f32 factor does (before the fix it
    lay 5.7x as far)."""
    n = c6.K.shape[-1]
    index = PackedBlockIndex.from_mask(c6.mask, n, c6.bs)

    def factor(K):
        K = torch.as_tensor(K)
        if storage == "dense":
            return block_cholesky(K.clone(), c6.bs, mask=c6.mask)
        return block_cholesky_packed(K, index).unpack()

    L64 = factor(c6.K)
    assert L64.dtype == torch.float64
    assert _rel(L64.numpy(), c6.L64) <= 1e-13
    L32 = factor(c6.K.astype(np.float32))
    assert L32.dtype == torch.float32
    port_err = _rel(L32.numpy(), c6.L64)
    rounding = _rel(c6.L64.astype(np.float32), c6.L64)
    assert 5 * rounding < c6.ref_err  # the f32 arithmetic's error, not fl32's
    assert port_err <= C6_RATIO * c6.ref_err, (port_err, c6.ref_err)


def test_f32_factor_of_a_full_mask_is_the_dense_factor():
    """Without a fill mask (the unmasked branch, no main path runs it) and
    with the full mask, dense and packed, the f32 factors agree with the
    f64 one to f32 accuracy and are lower triangular."""
    rng = np.random.default_rng(3)
    S, n, bs = 2, 45, 8
    A = rng.standard_normal((S, n, n))
    K = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    want = np.linalg.cholesky(K)
    nb = -(-n // bs)
    full = np.tril(np.ones((nb, nb), dtype=bool))
    K32 = torch.as_tensor(K, dtype=torch.float32)
    got = {
        "unmasked": block_cholesky(K32.clone(), bs),
        "masked": block_cholesky(K32.clone(), bs, mask=full),
        "packed": block_cholesky_packed(
            K32, PackedBlockIndex.from_mask(full, n, bs)).unpack(),
    }
    for name, L in got.items():
        assert L.dtype == torch.float32, name
        assert torch.equal(L, L.tril()), name
        assert _rel(L.numpy(), want) <= 1e-5, name
    assert torch.equal(got["masked"], got["packed"])


# ---------------------------------------------------------------------------
# the f32 fused kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["dense", "packed"])
@pytest.mark.parametrize("n,m,bs,bm,S,empty", [(61, 30, 8, 8, 2, 0),
                                               (96, 44, 16, 16, 2, 8)])
def test_plain_f32_fused_matches_reference_unfused(n, m, bs, bm, S, empty,
                                                   storage):
    ref = _reference()
    from test_torch_fused import _case

    from repro.core import build_stepped_meta as ref_meta
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_oracles
    from repro.sparse import packed as ref_packed
    from repro_torch.kernels import (
        stepped_trsm_syrk_kernel,
        stepped_trsm_syrk_packed_kernel,
    )

    L, pb, B, meta = _case(n, m, bs, bm, S, empty, seed=n + bm)
    L, pb, B = L.float(), pb.to(torch.float32), B.float()
    fac = pb if storage == "packed" else L
    launches = (dict(stepped_trsm_syrk_kernel.launches_by_dtype),
                dict(stepped_trsm_syrk_packed_kernel.launches_by_dtype))
    got = ops.stepped_trsm_syrk(fac, B, meta)
    assert got.dtype == torch.float32
    assert launches == (stepped_trsm_syrk_kernel.launches_by_dtype,
                        stepped_trsm_syrk_packed_kernel.launches_by_dtype)
    # the unfused f32 pair through the port's wrappers: the same schedule
    trsm = ops.stepped_trsm_packed if storage == "packed" else ops.stepped_trsm
    assert torch.equal(got, ops.stepped_syrk(trsm(fac, B, meta), meta))
    jnp = ref.jnp
    rmeta = ref_meta(B[0].numpy() != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    ref_index = ref_packed.PackedBlockIndex.from_mask(pb.index.mask, n, bs)
    for s in range(S):
        Bs = jnp.asarray(B[s].numpy())
        if storage == "packed":
            Y = ref_ops.stepped_trsm_packed(
                ref_packed.PackedBlocks(jnp.asarray(pb.values[s].numpy()),
                                        ref_index), Bs, rmeta, interpret=True)
        else:
            Y = ref_ops.stepped_trsm(jnp.asarray(L[s].numpy()), Bs, rmeta,
                                     interpret=True)
        F = ref_ops.stepped_syrk(Y, rmeta, interpret=True)
        assert F.dtype == jnp.float32
        assert _rel(got[s].numpy(), F) <= KERNEL_TOL
        oracle = ref_oracles.syrk_ref(ref_oracles.trsm_ref(
            jnp.asarray(L[s].numpy()), Bs))
        assert _rel(got[s].numpy(), oracle) <= KERNEL_TOL


# ---------------------------------------------------------------------------
# f32 and bf16 preprocessing and solves through the fused kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heat():
    ref = _reference()
    ref_prob = ref.decompose("heat", 2, (2, 2), (6, 6))
    prob = _carry(ref_prob)
    return types.SimpleNamespace(ref=ref, ref_prob=ref_prob, prob=prob,
                                 u_ref=prob.reference_solution())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("storage", ["dense", "packed"])
def test_fused_reduced_stacks_match_reference(heat, storage, dtype):
    ref = heat.ref
    fields = dict(block_size=8, rhs_block_size=8, storage=storage)
    want = ref.preprocess(heat.ref_prob, ref.FetiConfig(
        schur=ref.Config(**fields), dtype=dtype, plan_cache=False))
    got = preprocess_cluster(heat.prob, FetiConfig(
        schur=SchurAssemblyConfig(use_kernels=True, fused=True, **fields),
        dtype=dtype, device="cpu"))
    sdt = torch.float32 if dtype == "f32" else torch.bfloat16
    assert got.F.dtype == sdt and got.storage == storage
    want_F = np.asarray(want.F.astype(np.float32))
    # bf16: both round an f32 F̃ to bf16 once; an element whose f32 values
    # straddle a rounding boundary moves by one bf16 ulp (2^-8 relative)
    tol = STACK_TOL if dtype == "f32" else 2.0 ** -8
    assert _rel(got.F.float().numpy(), want_F) <= tol


@pytest.mark.parametrize("dtype,tol,bar", [("f32", 1e-10, 1e-8),
                                           ("bf16", 1e-6, 1e-2)])
def test_fused_reduced_solve_matches_oracle(heat, dtype, tol, bar):
    cfg = SchurAssemblyConfig(block_size=8, rhs_block_size=8,
                              use_kernels=True, fused=True)
    sol = FetiSolver(heat.prob, FetiConfig(
        schur=cfg, dtype=dtype, device="cpu")).solve(tol=tol, max_iter=500)
    assert sol.storage_dtype == dtype and sol.compute_dtype == "f32"
    err = np.abs(sol.u_global - heat.u_ref).max() / np.abs(heat.u_ref).max()
    assert err <= bar
    if dtype == "f32":
        assert sol.converged and sol.refine_outer >= 1
