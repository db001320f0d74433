"""The port's factorization and Schur assembly against the reference's.

Same seeded inputs go to both packages; assembly outputs (L, F̃) agree to
1e-12 relative to their scale (f64; the two libraries sum in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import SchurAssemblyConfig as RefConfig  # noqa: E402
from repro.core import assemble_schur as ref_assemble_schur  # noqa: E402
from repro.core import assembly_flops as ref_assembly_flops  # noqa: E402
from repro.core import build_stepped_meta as ref_meta  # noqa: E402
from repro.fem import decompose_problem as ref_decompose  # noqa: E402
from repro.feti import FetiConfig as RefFetiConfig  # noqa: E402
from repro.feti import preprocess_cluster as ref_preprocess  # noqa: E402
from repro.sparse.cholesky import block_cholesky as ref_block_cholesky  # noqa: E402

from repro_torch.core import (  # noqa: E402
    SchurAssemblyConfig,
    assemble_schur,
    assembly_flops,
    build_stepped_meta,
    schur_dense_baseline,
)
from repro_torch.feti import FetiConfig, preprocess_cluster  # noqa: E402
from repro_torch.interop import from_reference_problem  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    block_cholesky,
    block_pattern,
    block_symbolic_cholesky,
    matrix_pattern_from_elems,
    node_ordering,
)
from repro_torch.fem.meshgen import structured_mesh  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-12


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0))


def _stiffness_stack(elems, S, seed):
    """S regularized, ND-permuted heat-like stiffness matrices on one
    structured pattern (random positive coefficients), and the mask."""
    mesh = structured_mesh(elems)
    n = mesh.n_nodes
    perm = node_ordering(tuple(e + 1 for e in elems), "nd")
    rng = np.random.default_rng(seed)
    Ks = []
    for _ in range(S):
        K = np.zeros((n, n))
        for e in mesh.elems:
            w = rng.uniform(0.5, 2.0)
            for a in e:
                for b in e:
                    K[a, b] += w * (2.0 if a == b else -1.0)
        K += np.eye(n) * 0.1
        Ks.append(K[perm][:, perm])
    pat = matrix_pattern_from_elems(n, mesh.elems)[perm][:, perm]
    return np.stack(Ks), pat


@pytest.mark.parametrize("elems,bs,masked", [
    ((6, 6), 8, True), ((6, 6), 8, False), ((7, 5), 16, True), ((4, 4), 5, True),
])
def test_block_cholesky_matches_reference(elems, bs, masked):
    K, pat = _stiffness_stack(elems, 2, seed=bs)
    mask = block_symbolic_cholesky(block_pattern(pat, bs)) if masked else None
    L = block_cholesky(torch.from_numpy(K.copy()), bs, mask=mask).numpy()
    ref = jax.jit(jax.vmap(lambda k: ref_block_cholesky(k, bs, mask=mask)))
    want = ref(jnp.asarray(K))
    for s in range(2):
        _close(L[s], want[s])
        np.testing.assert_array_equal(np.triu(L[s], 1), 0.0)


def test_block_cholesky_rejects_indefinite():
    K = -np.eye(8)[None]
    with pytest.raises(ValueError, match="positive definite"):
        block_cholesky(torch.from_numpy(K.copy()), 4)


VARIANTS = [(t, s) for t in ("dense", "rhs_split", "factor_split")
            for s in ("dense", "input_split", "output_split")]


@pytest.fixture(scope="module")
def factor_case():
    K, pat = _stiffness_stack((7, 7), 2, seed=1)
    mask = block_symbolic_cholesky(block_pattern(pat, 8))
    L = np.stack([np.linalg.cholesky(k) for k in K])
    rng = np.random.default_rng(2)
    n, m = L.shape[1], 30
    Bt = np.zeros((n, m))
    rows = rng.choice(n, size=m, replace=False)
    Bt[rows, np.arange(m)] = rng.choice([-1.0, 1.0], size=m)
    Bt[:, -4:] = 0.0  # padding columns, as subdomains with m < m_max have
    return L, Bt, mask


@pytest.mark.parametrize("trsm,syrk", VARIANTS + [("kernels", "kernels")])
def test_assembly_grid_matches_reference(factor_case, trsm, syrk):
    L, Bt, mask = factor_case
    if trsm == "kernels":
        cfg = SchurAssemblyConfig(block_size=8, rhs_block_size=8,
                                  use_kernels=True)
        ref_cfg = RefConfig(block_size=8, rhs_block_size=8, use_pallas=True,
                            interpret=True, storage="dense")
    else:
        cfg = SchurAssemblyConfig(trsm_variant=trsm, syrk_variant=syrk,
                                  block_size=8, rhs_block_size=8)
        ref_cfg = RefConfig(trsm_variant=trsm, syrk_variant=syrk,
                            block_size=8, rhs_block_size=8, storage="dense")
    meta = build_stepped_meta(Bt != 0, block_size=8, rhs_block_size=8)
    rmeta = ref_meta(Bt != 0, block_size=8, rhs_block_size=8)
    F = assemble_schur(torch.from_numpy(L),
                       torch.from_numpy(np.broadcast_to(Bt, (2,) + Bt.shape).copy()),
                       meta, cfg, block_mask=mask).numpy()
    ref = jax.jit(jax.vmap(lambda L_: ref_assemble_schur(
        L_, jnp.asarray(Bt), rmeta, ref_cfg, block_mask=mask)))
    _close(F, ref(jnp.asarray(L)))
    base = schur_dense_baseline(torch.from_numpy(L), torch.from_numpy(
        np.broadcast_to(Bt, (2,) + Bt.shape).copy())).numpy()
    _close(F, base)
    assert assembly_flops(meta, cfg) == ref_assembly_flops(rmeta, ref_cfg)


@pytest.fixture(scope="module")
def reference_problem():
    return ref_decompose("heat", 2, (3, 3), (4, 4))


@pytest.mark.parametrize("kernels,ordering", [
    (False, "nd"), (True, "nd"), (False, "rcm")])
def test_preprocess_cluster_matches_reference(reference_problem, kernels,
                                              ordering):
    ref = reference_problem
    prob = from_reference_problem(dict(
        subdomains=[dict(K=sd.K, Bt=sd.Bt, f=sd.f, R=sd.R,
                         lambda_ids=sd.lambda_ids, m=sd.m,
                         dof_gids=sd.dof_gids, fixing_dofs=sd.fixing_dofs,
                         b_rows=sd.b_rows, b_vals=sd.b_vals)
                    for sd in ref.subdomains],
        c=ref.c, n_lambda=ref.n_lambda, dirichlet_gids=ref.dirichlet_gids,
        coords=ref.global_mesh.coords, elems=ref.global_mesh.elems, dim=2,
        sub_grid=ref.sub_grid, elems_per_sub=ref.elems_per_sub))
    kw = dict(block_size=8, rhs_block_size=8)
    st = preprocess_cluster(prob, FetiConfig(
        schur=SchurAssemblyConfig(use_kernels=kernels, **kw),
        ordering=ordering, device="cpu"))
    ref_st = ref_preprocess(ref, RefFetiConfig(schur=RefConfig(
        use_pallas=kernels, interpret=kernels, storage="dense", **kw),
        ordering=ordering, plan_cache=False))
    _close(st.L.numpy(), ref_st.L)
    _close(st.F.numpy(), ref_st.F)
    np.testing.assert_array_equal(st.node_perm, ref_st.node_perm)
    np.testing.assert_array_equal(st.block_mask, ref_st.block_mask)
    np.testing.assert_array_equal(st.K.values.numpy(), np.asarray(ref_st.K.values))
    np.testing.assert_array_equal(st.Btp.numpy(), np.asarray(ref_st.Btp))
