"""The port's packed factor storage against the reference's.

Same seeded numpy inputs go to both packages (packed factors carried over
with ``repro_torch.interop.from_reference_packed``): the packed Cholesky,
the packed triangular solves, the packed factor-split TRSM, the packed
stepped TRSM's plain version (against the reference's Pallas kernel in
interpret mode), the 3×3 variant grid on a packed factor, the packed
preprocessing and the packed FETI solve. Assembly outputs agree to 1e-12
relative to their scale (f64, sums in another order); solves to 1e-8 of
scipy with the reference's iteration count at the launcher's tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    SchurAssemblyConfig,
    assemble_schur,
    assembly_flops,
    build_stepped_meta,
    schur_dense_baseline,
)
from repro_torch.core.trsm import trsm_factor_split_packed  # noqa: E402
from repro_torch.fem.meshgen import structured_mesh  # noqa: E402
from repro_torch.interop import from_reference_packed  # noqa: E402
from repro_torch.kernels import ops, stepped_trsm_packed_kernel  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    PackedBlockIndex,
    PackedBlocks,
    block_cholesky,
    block_cholesky_packed,
    block_pattern,
    block_symbolic_cholesky,
    matrix_pattern_from_elems,
    node_ordering,
    pack_factor,
    packed_tri_solve,
)

pytestmark = pytest.mark.torch_port

TOL = 1e-12


def _reference():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.sparse import packed as ref_packed

    return jax, jnp, ref_packed


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _stiffness_stack(elems, S, seed, ordering):
    """S regularized, permuted heat-like stiffness matrices on one
    structured pattern (random positive coefficients), and the pattern."""
    mesh = structured_mesh(elems)
    n = mesh.n_nodes
    perm = node_ordering(tuple(e + 1 for e in elems), ordering)
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


def _packed_case(ordering, bs, seed=0):
    """(K stack, fill mask, port index, port packed factor); 7 block rows
    at either block size, the last one ragged."""
    elems = (4, 4) if bs == 4 else (6, 6)
    K, pat = _stiffness_stack(elems, 2, seed=seed + bs, ordering=ordering)
    mask = block_symbolic_cholesky(block_pattern(pat, bs))
    index = PackedBlockIndex.from_mask(mask, K.shape[1], bs)
    return K, mask, index, block_cholesky_packed(torch.from_numpy(K), index)


def _ref_packed_values(K, mask, bs):
    jax, jnp, ref_packed = _reference()
    ref_index = ref_packed.PackedBlockIndex.from_mask(mask, K.shape[1], bs)
    vals = jax.jit(jax.vmap(lambda k: ref_packed.block_cholesky_packed(
        k, ref_index).values))(jnp.asarray(K))
    return np.asarray(vals), ref_index


@pytest.mark.parametrize("ordering", ["nd", "rcm"])
@pytest.mark.parametrize("bs", [4, 8])
def test_block_cholesky_packed_matches_reference(ordering, bs):
    K, mask, index, L = _packed_case(ordering, bs)
    want, _ = _ref_packed_values(K, mask, bs)
    assert L.index.n_blocks < L.index.nb * (L.index.nb + 1) // 2  # sparse
    _close(L.values.numpy(), want)
    # the dense masked factorization stores the same blocks
    dense = block_cholesky(torch.from_numpy(K.copy()), bs, mask=mask)
    _close(L.values.numpy(), pack_factor(dense, index).values.numpy())
    # in place on a packed stack: the same values, in the same tensor
    Kp = PackedBlocks(index.pack(torch.from_numpy(K), diag_identity_pad=True),
                      index)
    out = block_cholesky_packed(Kp, index)
    assert out.values is Kp.values
    np.testing.assert_array_equal(out.values.numpy(), L.values.numpy())


def test_block_cholesky_packed_rejects_indefinite():
    index = PackedBlockIndex.full(8, 4)
    with pytest.raises(ValueError, match="positive definite"):
        block_cholesky_packed(-torch.eye(8, dtype=torch.float64)[None], index)


@pytest.mark.parametrize("ordering,bs,transpose", [
    ("nd", 4, False), ("rcm", 8, True)])
def test_packed_tri_solve_matches_reference(ordering, bs, transpose):
    jax, jnp, ref_packed = _reference()
    K, mask, index, L = _packed_case(ordering, bs, seed=3)
    # both packages solve with the reference's factor, carried over
    ref_vals, ref_index = _ref_packed_values(K, mask, bs)
    L = from_reference_packed(ref_vals, mask, K.shape[1], bs)
    np.testing.assert_array_equal(L.index.rows, ref_index.rows)
    np.testing.assert_array_equal(L.index.cols, ref_index.cols)
    rng = np.random.default_rng(bs)
    b = rng.standard_normal((2, K.shape[1]))
    got = packed_tri_solve(L, torch.from_numpy(b), transpose=transpose)
    want = jax.jit(jax.vmap(lambda v, x: ref_packed.packed_tri_solve(
        ref_packed.PackedBlocks(v, ref_index), x, transpose)))(
        jnp.asarray(L.values.numpy()), jnp.asarray(b))
    _close(got.numpy(), want)
    Ld = L.unpack()
    dense = torch.linalg.solve_triangular(
        Ld.mT if transpose else Ld, torch.from_numpy(b)[..., None],
        upper=transpose)[..., 0]
    _close(got.numpy(), dense.numpy())


def _stepped_rhs(n, m, rng, empty=0):
    """B̃ᵀ-like (n, m): ±1 near a random anchor row per column, the last
    ``empty`` columns zero."""
    Bt = np.zeros((n, m))
    for j in range(m - empty):
        a = int(rng.integers(0, n))
        for r in np.unique(np.clip(a + rng.integers(0, 5, size=2), 0, n - 1)):
            Bt[r, j] = rng.choice([-1.0, 1.0])
    return Bt


@pytest.mark.parametrize("ordering,bs,bm,empty", [
    ("nd", 4, 4, 0), ("rcm", 8, 4, 6)])
def test_trsm_factor_split_packed_matches_reference(ordering, bs, bm, empty):
    jax, jnp, ref_packed = _reference()
    from repro.core import build_stepped_meta as ref_meta
    from repro.core.trsm import trsm_factor_split_packed as ref_trsm

    K, mask, index, L = _packed_case(ordering, bs, seed=5)
    n = K.shape[1]
    Bt = _stepped_rhs(n, 20, np.random.default_rng(bs + bm), empty)
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    Bp = np.broadcast_to(Bt[:, meta.perm], (2, n, 20)).copy()
    got = trsm_factor_split_packed(L, torch.from_numpy(Bp), meta)
    rmeta = ref_meta(Bp[0] != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    ref_index = ref_packed.PackedBlockIndex.from_mask(mask, n, bs)
    want = jax.jit(jax.vmap(lambda v: ref_trsm(
        ref_packed.PackedBlocks(v, ref_index), jnp.asarray(Bp[0]), rmeta)))(
        jnp.asarray(L.values.numpy()))
    _close(got.numpy(), want)
    _close(got.numpy(), torch.linalg.solve_triangular(
        L.unpack(), torch.from_numpy(Bp), upper=False).numpy())


@pytest.mark.parametrize("ordering,bs,bm,empty", [
    ("nd", 4, 4, 0),  # n = 25: ragged last block
    ("rcm", 8, 8, 0),
    ("nd", 8, 8, 8),  # the last stripe's columns are empty
])
def test_plain_packed_trsm_matches_reference(ordering, bs, bm, empty):
    jax, jnp, ref_packed = _reference()
    from repro.core import build_stepped_meta as ref_meta
    from repro.kernels import ops as ref_ops

    K, mask, index, L = _packed_case(ordering, bs, seed=7)
    n = K.shape[1]
    Bt = _stepped_rhs(n, 24, np.random.default_rng(bs * bm), empty)
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    Bp = np.broadcast_to(Bt[:, meta.perm], (2, n, 24)).copy()
    before = stepped_trsm_packed_kernel.launches
    got = ops.stepped_trsm_packed(L, torch.from_numpy(Bp), meta)
    assert stepped_trsm_packed_kernel.launches == before  # CPU: plain version
    rmeta = ref_meta(Bp[0] != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    ref_index = ref_packed.PackedBlockIndex.from_mask(mask, n, bs)
    for s in range(2):
        want = ref_ops.stepped_trsm_packed(
            ref_packed.PackedBlocks(jnp.asarray(L.values[s].numpy()),
                                    ref_index),
            jnp.asarray(Bp[s]), rmeta, interpret=True)
        _close(got[s].numpy(), want)
    # its dense twin (the stepped TRSM's plain version on the unpacked factor)
    _close(got.numpy(), ops.stepped_trsm(L.unpack(), torch.from_numpy(Bp),
                                         meta).numpy())


VARIANTS = [(t, s) for t in ("dense", "rhs_split", "factor_split")
            for s in ("dense", "input_split", "output_split")]


@pytest.fixture(scope="module")
def packed_factor_case():
    K, mask, index, L = _packed_case("nd", 8, seed=11)
    rng = np.random.default_rng(2)
    n, m = K.shape[1], 30
    Bt = np.zeros((n, m))
    rows = rng.choice(n, size=m - 4, replace=False)
    Bt[rows, np.arange(m - 4)] = rng.choice([-1.0, 1.0], size=m - 4)
    return L, Bt, mask


@pytest.mark.parametrize("trsm,syrk", VARIANTS + [("kernels", "kernels")])
def test_assembly_grid_packed_matches_reference(packed_factor_case, trsm,
                                               syrk):
    jax, jnp, ref_packed = _reference()
    from repro.core import SchurAssemblyConfig as RefConfig
    from repro.core import assemble_schur as ref_assemble_schur
    from repro.core import assembly_flops as ref_assembly_flops
    from repro.core import build_stepped_meta as ref_meta

    L, Bt, mask = packed_factor_case
    kw = dict(block_size=8, rhs_block_size=8, storage="packed")
    if trsm == "kernels":
        cfg = SchurAssemblyConfig(use_kernels=True, **kw)
        ref_cfg = RefConfig(use_pallas=True, interpret=True, **kw)
    else:
        cfg = SchurAssemblyConfig(trsm_variant=trsm, syrk_variant=syrk, **kw)
        ref_cfg = RefConfig(trsm_variant=trsm, syrk_variant=syrk, **kw)
    meta = build_stepped_meta(Bt != 0, block_size=8, rhs_block_size=8)
    rmeta = ref_meta(Bt != 0, block_size=8, rhs_block_size=8)
    B = torch.from_numpy(np.broadcast_to(Bt, (2,) + Bt.shape).copy())
    F = assemble_schur(L, B, meta, cfg, block_mask=mask).numpy()
    ref_index = ref_packed.PackedBlockIndex.from_mask(mask, Bt.shape[0], 8)
    ref = jax.jit(jax.vmap(lambda v: ref_assemble_schur(
        ref_packed.PackedBlocks(v, ref_index), jnp.asarray(Bt), rmeta,
        ref_cfg, block_mask=mask)))
    _close(F, ref(jnp.asarray(L.values.numpy())))
    _close(F, schur_dense_baseline(L.unpack(), B).numpy())
    # a dense factor is packed on the fly with the mask's index
    _close(assemble_schur(L.unpack(), B, meta, cfg, block_mask=mask).numpy(), F)
    assert assembly_flops(meta, cfg) == ref_assembly_flops(rmeta, ref_cfg)


def test_packed_storage_config_and_bytes():
    from repro_torch.configs import get_smoke_config
    from repro_torch.fem import decompose_problem
    from repro_torch.feti import FetiConfig, preprocess_cluster

    with pytest.raises(ValueError, match="storage"):
        SchurAssemblyConfig(storage="sparse")
    with pytest.raises(ValueError, match="storage"):
        FetiConfig(storage="sparse")
    fc = FetiConfig(storage="packed")
    assert fc.resolved_schur().storage == "packed"
    assert FetiConfig(schur=SchurAssemblyConfig(storage="packed"),
                      storage="dense").resolved_schur().storage == "dense"
    sc = get_smoke_config("feti-heat-2d")
    prob = decompose_problem("heat", 2, (3, 3), (8, 8))
    st = preprocess_cluster(prob, FetiConfig(
        schur=SchurAssemblyConfig(block_size=sc.block_size), storage="packed",
        device="cpu"))
    assert st.storage == "packed" and isinstance(st.L, PackedBlocks)
    by = st.device_bytes()
    assert by["L"] == st.L.nbytes == st.index.packed_nbytes() * st.S
    assert by["dense_L"] == st.S * st.index.n ** 2 * 8
    assert by["L"] < by["dense_L"]
    assert by["total"] == by["L"] + by["K"] + by["Btp"] + by["F"]


@pytest.fixture(scope="module")
def reference_problem():
    pytest.importorskip("jax")
    from repro.fem import decompose_problem as ref_decompose

    return ref_decompose("heat", 2, (3, 3), (4, 4))


def _carry(ref):
    from repro_torch.interop import SUBDOMAIN_KEYS, from_reference_problem

    return from_reference_problem(dict(
        subdomains=[{k: getattr(sd, k) for k in SUBDOMAIN_KEYS}
                    for sd in ref.subdomains],
        c=ref.c, n_lambda=ref.n_lambda, dirichlet_gids=ref.dirichlet_gids,
        coords=ref.global_mesh.coords, elems=ref.global_mesh.elems,
        dim=ref.dim, sub_grid=ref.sub_grid,
        elems_per_sub=ref.elems_per_sub, params=ref.params))


@pytest.mark.parametrize("kernels,ordering", [(False, "nd"), (True, "rcm")])
def test_preprocess_cluster_packed_matches_reference(reference_problem,
                                                     kernels, ordering):
    from repro.core import SchurAssemblyConfig as RefConfig
    from repro.feti import FetiConfig as RefFetiConfig
    from repro.feti import preprocess_cluster as ref_preprocess
    from repro_torch.feti import FetiConfig, preprocess_cluster

    ref = reference_problem
    kw = dict(block_size=8, rhs_block_size=8)
    st = preprocess_cluster(_carry(ref), FetiConfig(
        schur=SchurAssemblyConfig(use_kernels=kernels, **kw),
        ordering=ordering, storage="packed", device="cpu"))
    ref_st = ref_preprocess(ref, RefFetiConfig(schur=RefConfig(
        use_pallas=kernels, interpret=kernels, storage="packed", **kw),
        ordering=ordering, plan_cache=False))
    assert st.storage == ref_st.storage == "packed"
    np.testing.assert_array_equal(st.index.rows, ref_st.L.index.rows)
    np.testing.assert_array_equal(st.index.cols, ref_st.L.index.cols)
    _close(st.L.values.numpy(), ref_st.L.values)
    _close(st.F.numpy(), ref_st.F)
    np.testing.assert_array_equal(st.K.values.numpy(),
                                  np.asarray(ref_st.K.values))


SOLVES = [("kernels", "explicit"), ("kernels", "implicit"),
          ("fused", "explicit"), ("fused", "implicit")]


@pytest.fixture(scope="module")
def packed_solves(reference_problem):
    """Reference (packed storage) and port (packed, through the kernel
    paths) solutions at the launcher's tolerance."""
    from repro.core import SchurAssemblyConfig as RefConfig
    from repro.feti import FetiConfig as RefFetiConfig
    from repro.feti import FetiSolver as RefSolver
    from repro_torch.feti import FetiConfig, FetiSolver

    ref = reference_problem
    prob = _carry(ref)
    ref_cfg = RefConfig(block_size=8, rhs_block_size=8, storage="packed")
    want, state = {}, None
    for mode in ("explicit", "implicit"):
        rs = RefSolver(ref, RefFetiConfig(schur=ref_cfg, mode=mode,
                                          plan_cache=False))
        if state is not None:
            rs.state = state  # the explicit state serves the implicit solve
        want[mode] = rs.solve(tol=1e-9)
        state = rs.state
    got = {}
    for path, mode in SOLVES:
        cfg = SchurAssemblyConfig(block_size=8, rhs_block_size=8,
                                  use_kernels=True, fused=path == "fused")
        got[path, mode] = FetiSolver(prob, FetiConfig(
            schur=cfg, mode=mode, storage="packed",
            device="cpu")).solve(tol=1e-9)
    return prob.reference_solution(), want, got


@pytest.mark.parametrize("path,mode", SOLVES)
def test_packed_solve_matches_oracle_and_reference(packed_solves, path, mode):
    u_ref, want, got = packed_solves
    g, w = got[path, mode], want[mode]
    assert g.converged and w.converged
    assert g.iterations == w.iterations
    np.testing.assert_allclose(g.u_global, u_ref, rtol=0,
                               atol=1e-8 * np.abs(u_ref).max())
    np.testing.assert_allclose(g.lam, np.asarray(w.lam), rtol=0,
                               atol=1e-9 * np.abs(w.lam).max())
