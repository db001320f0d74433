"""The port's host symbolic copies are array-equal to the reference's:
stepped metadata, orderings, block patterns and fill masks, the mesh
generator, the node-to-DOF expansions and the packed block index."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import stepped as ref_stepped  # noqa: E402
from repro.fem import meshgen as ref_meshgen  # noqa: E402
from repro.feti import assembly as ref_assembly  # noqa: E402
from repro.sparse import ordering as ref_ordering  # noqa: E402
from repro.sparse import packed as ref_packed  # noqa: E402
from repro.sparse import symbolic as ref_symbolic  # noqa: E402
from repro.testing import random_feti_like_bt  # noqa: E402

from repro_torch.core import stepped  # noqa: E402
from repro_torch.fem import meshgen  # noqa: E402
from repro_torch.feti import assembly  # noqa: E402
from repro_torch.sparse import ordering, packed, symbolic  # noqa: E402

pytestmark = pytest.mark.torch_port

META_FIELDS = ("n", "m", "block_size", "rhs_block_size", "perm", "inv_perm",
               "pivots", "widths", "col_starts")
FLOPS = ("flops_trsm_dense", "flops_trsm_rhs_split", "flops_trsm_factor_split",
         "flops_syrk_dense", "flops_syrk_input_split", "flops_syrk_output_split")


def _assert_meta_equal(got, want):
    for f in META_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in FLOPS:
        assert getattr(got, f)() == getattr(want, f)(), f


@pytest.mark.parametrize("n,m,bs,bm,seed", [
    (64, 32, 16, 8, 0), (60, 28, 16, 16, 1), (130, 70, 32, 16, 2),
])
def test_stepped_meta_matches_reference(n, m, bs, bm, seed):
    rng = np.random.default_rng(seed)
    pattern = random_feti_like_bt(n, m, rng) != 0
    pattern[:, -3:] = False  # empty columns: pivot n
    np.testing.assert_array_equal(stepped.column_pivots(pattern),
                                  ref_stepped.column_pivots(pattern))
    piv = stepped.column_pivots(pattern)
    np.testing.assert_array_equal(stepped.stepped_permutation(piv),
                                  ref_stepped.stepped_permutation(piv))
    metas = [stepped.build_stepped_meta(pattern, bs, bm),
             stepped.build_stepped_meta(pattern[:, ::-1], bs, bm)]
    refs = [ref_stepped.build_stepped_meta(pattern, bs, bm),
            ref_stepped.build_stepped_meta(pattern[:, ::-1], bs, bm)]
    for got, want in zip(metas, refs):
        _assert_meta_equal(got, want)
    _assert_meta_equal(stepped.shared_envelope(metas),
                       ref_stepped.shared_envelope(refs))


@pytest.mark.parametrize("shape", [(5, 5), (9, 7), (17, 17), (65, 65), (4, 5, 6)])
@pytest.mark.parametrize("name", ["nd", "rcm", "natural"])
def test_orderings_match_reference(shape, name):
    np.testing.assert_array_equal(ordering.node_ordering(shape, name),
                                  ref_ordering.node_ordering(shape, name))


@pytest.mark.parametrize("elems,bs,name", [
    ((4, 4), 8, "nd"), ((8, 6), 16, "rcm"), ((16, 16), 32, "nd"),
    ((64, 64), 128, "nd"),  # feti-heat-2d's full-size subdomain
])
def test_block_fill_masks_match_reference(elems, bs, name):
    mesh, ref_mesh = meshgen.structured_mesh(elems), ref_meshgen.structured_mesh(elems)
    np.testing.assert_array_equal(mesh.coords, ref_mesh.coords)
    np.testing.assert_array_equal(mesh.elems, ref_mesh.elems)
    n = mesh.n_nodes
    pat = symbolic.matrix_pattern_from_elems(n, mesh.elems)
    np.testing.assert_array_equal(
        pat, ref_symbolic.matrix_pattern_from_elems(n, ref_mesh.elems))
    perm = ordering.node_ordering(tuple(e + 1 for e in elems), name)
    pat = pat[perm][:, perm]
    bpat = symbolic.block_pattern(pat, bs)
    np.testing.assert_array_equal(bpat, ref_symbolic.block_pattern(pat, bs))
    mask = symbolic.block_symbolic_cholesky(bpat)
    np.testing.assert_array_equal(mask, ref_symbolic.block_symbolic_cholesky(bpat))
    idx = packed.PackedBlockIndex.from_mask(mask, n, bs)
    ref_idx = ref_packed.PackedBlockIndex.from_mask(mask, n, bs)
    for f in ("rows", "cols", "rowptr", "slot_table", "diag_slots"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(ref_idx, f))
    if elems == (64, 64):
        # the full-size shapes the port's kernels are built around
        assert (n, idx.nb, int(mask.sum())) == (4225, 34, 142)


def test_structured_mesh_3d_and_offsets_match_reference():
    for args in [((3, 2, 2),), ((4, 4), (0.25, 0.5), (0.25, 0.25))]:
        got, want = meshgen.structured_mesh(*args), ref_meshgen.structured_mesh(*args)
        np.testing.assert_array_equal(got.coords, want.coords)
        np.testing.assert_array_equal(got.elems, want.elems)


@pytest.mark.parametrize("ndpn", [1, 2, 3])
def test_node_expansions_match_reference(ndpn):
    perm = ordering.node_ordering((5, 4), "nd")
    np.testing.assert_array_equal(assembly.expand_node_perm(perm, ndpn),
                                  ref_assembly.expand_node_perm(perm, ndpn))
    pat = symbolic.matrix_pattern_from_elems(
        20, meshgen.structured_mesh((4, 3)).elems)
    np.testing.assert_array_equal(assembly.expand_node_pattern(pat, ndpn),
                                  ref_assembly.expand_node_pattern(pat, ndpn))
