"""The port's heat decomposition against the reference's.

K, f and the global oracle come from element integrals the two packages
compute with different libraries (numpy here, jnp there) and sum in
another order, so they agree to 1e-13 relative; every integer array, the
±1 gluing and the kernel basis are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fem import decompose_problem as ref_decompose  # noqa: E402
from repro.fem.assembly import load_vector as ref_load_vector  # noqa: E402
from repro.fem.assembly import p1_element_stiffness as ref_stiffness  # noqa: E402
from repro.fem.regularization import (  # noqa: E402
    fixing_dofs_regularization as ref_regularization,
)
from repro.fem.regularization import kernel_basis as ref_kernel_basis  # noqa: E402

from repro_torch.fem import (  # noqa: E402
    decompose_problem,
    fixing_dofs_regularization,
    kernel_basis,
)
from repro_torch.fem.assembly import load_vector, p1_element_stiffness  # noqa: E402
from repro_torch.fem.meshgen import structured_mesh  # noqa: E402
from repro_torch.interop import SUBDOMAIN_KEYS, from_reference_problem  # noqa: E402

pytestmark = pytest.mark.torch_port

RTOL = 1e-13
EXACT = ("Bt", "lambda_ids", "dof_gids", "node_gids", "R", "fixing_dofs",
         "b_rows", "b_vals")


def _reference_arrays(prob):
    """The reference problem as the plain host arrays the port takes."""
    return dict(
        subdomains=[{k: getattr(sd, k) for k in SUBDOMAIN_KEYS + ("node_gids",)}
                    for sd in prob.subdomains],
        c=prob.c, n_lambda=prob.n_lambda, dirichlet_gids=prob.dirichlet_gids,
        coords=prob.global_mesh.coords, elems=prob.global_mesh.elems,
        dim=prob.dim, sub_grid=prob.sub_grid,
        elems_per_sub=prob.elems_per_sub, params=prob.params)


def _assert_problems_match(got, want):
    assert (got.n_lambda, got.m_max, got.n_subdomains) == (
        want.n_lambda, want.m_max, want.n_subdomains)
    np.testing.assert_array_equal(got.c, want.c)
    np.testing.assert_array_equal(got.dirichlet_gids, want.dirichlet_gids)
    np.testing.assert_array_equal(got.global_mesh.coords, want.global_mesh.coords)
    np.testing.assert_array_equal(got.global_mesh.elems, want.global_mesh.elems)
    for a, b in zip(got.subdomains, want.subdomains):
        assert a.m == b.m and a.fixing_node == b.fixing_node
        for k in EXACT:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        np.testing.assert_allclose(a.K, b.K, rtol=0,
                                   atol=RTOL * np.abs(b.K).max())
        np.testing.assert_allclose(a.f, b.f, rtol=RTOL, atol=0)


@pytest.fixture(scope="module", params=[((2, 2), (4, 4)), ((3, 2), (5, 4))],
                ids=["2x2-4x4", "3x2-5x4"])
def problems(request):
    grid, elems = request.param
    return (decompose_problem("heat", 2, grid, elems),
            ref_decompose("heat", 2, grid, elems))


def test_decomposition_matches_reference(problems):
    got, want = problems
    _assert_problems_match(got, want)


def test_reference_solution_matches(problems):
    got, want = problems
    u, u_ref = got.reference_solution(), want.reference_solution()
    np.testing.assert_allclose(u, u_ref, rtol=0,
                               atol=1e-12 * np.abs(u_ref).max())


def test_interop_carries_the_reference_decomposition(problems):
    port, ref = problems
    carried = from_reference_problem(_reference_arrays(ref))
    for a, b in zip(carried.subdomains, ref.subdomains):
        for k in SUBDOMAIN_KEYS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
    assert carried.n_lambda == ref.n_lambda
    np.testing.assert_array_equal(carried.reference_solution(),
                                  port.reference_solution())


def test_element_integrals_match_reference():
    mesh = structured_mesh((6, 5), origin=(0.5, 0.25), lengths=(0.5, 0.25))
    np.testing.assert_allclose(
        p1_element_stiffness(mesh.coords, mesh.elems, kappa=2.0),
        np.asarray(ref_stiffness(mesh.coords, mesh.elems, kappa=2.0)),
        rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(
        load_vector(mesh.coords, mesh.elems, mesh.n_nodes, source=3.0),
        np.asarray(ref_load_vector(mesh.coords, mesh.elems, mesh.n_nodes,
                                   source=3.0)),
        rtol=RTOL, atol=0)


def test_regularization_and_kernel_basis_match_reference(problems):
    got, _ = problems
    sd = got.subdomains[0]
    np.testing.assert_array_equal(
        fixing_dofs_regularization(sd.K, sd.fixing_dofs),
        ref_regularization(sd.K, sd.fixing_dofs))
    np.testing.assert_array_equal(kernel_basis(sd.n),
                                  ref_kernel_basis(sd.n, "heat"))
