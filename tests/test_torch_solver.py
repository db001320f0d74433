"""The port's FETI solve against the reference's and the scipy oracle.

Both packages solve the identical decomposition (the reference's host
arrays carried over with ``repro_torch.interop``): ``u`` within 1e-8 of
the undecomposed scipy solve, ``lam`` within 1e-9 of the reference's, and
the same PCPG iteration count. The port assembles through its kernel path
(plain versions on the CPU), the reference through the launcher's default
factor-split/input-split variants; both give F̃ to 1e-12, and the kernel
path's agreement with the reference's Pallas pair is held in
test_torch_assembly.py. One reference factorization per problem serves its
four (mode, preconditioner) solves. The dual tolerance is the launcher's
1e-9: tighter, the last iterations run at rounding level and the
reference's own explicit and implicit modes stop an iteration apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SchurAssemblyConfig as RefConfig  # noqa: E402
from repro.fem import decompose_problem as ref_decompose  # noqa: E402
from repro.feti import FetiConfig as RefFetiConfig  # noqa: E402
from repro.feti import FetiSolver as RefSolver  # noqa: E402

from repro_torch.core import SchurAssemblyConfig  # noqa: E402
from repro_torch.feti import FetiConfig, FetiSolver  # noqa: E402
from repro_torch.interop import SUBDOMAIN_KEYS, from_reference_problem  # noqa: E402
from repro_torch.launch import solve_feti  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-9
MODES = [(mode, pc) for mode in ("explicit", "implicit")
         for pc in ("lumped", "none")]


def _carry(ref):
    return from_reference_problem(dict(
        subdomains=[{k: getattr(sd, k) for k in SUBDOMAIN_KEYS}
                    for sd in ref.subdomains],
        c=ref.c, n_lambda=ref.n_lambda, dirichlet_gids=ref.dirichlet_gids,
        coords=ref.global_mesh.coords, elems=ref.global_mesh.elems,
        dim=ref.dim, sub_grid=ref.sub_grid,
        elems_per_sub=ref.elems_per_sub, params=ref.params))


@pytest.fixture(scope="module", params=[((2, 2), (4, 4), 8), ((4, 4), (4, 4), 8)],
                ids=["smoke-2x2", "4x4"])
def solved(request):
    """Reference and port solutions for every (mode, preconditioner)."""
    grid, elems, bs = request.param
    ref = ref_decompose("heat", 2, grid, elems)
    prob = _carry(ref)
    u_ref = prob.reference_solution()
    ref_cfg = RefConfig(block_size=bs, rhs_block_size=bs, storage="dense")
    state = None
    out = {}
    for mode, pc in MODES:
        rs = RefSolver(ref, RefFetiConfig(schur=ref_cfg, mode=mode,
                                          preconditioner=pc, plan_cache=False))
        if state is not None:
            rs.state = state  # an explicit state serves the implicit solves
        want = rs.solve(tol=TOL)
        state = rs.state
        got = FetiSolver(prob, FetiConfig(
            schur=SchurAssemblyConfig(block_size=bs, rhs_block_size=bs,
                                      use_kernels=True),
            mode=mode, preconditioner=pc, device="cpu")).solve(tol=TOL)
        out[mode, pc] = (got, want)
    return u_ref, out


@pytest.mark.parametrize("mode,pc", MODES)
def test_solution_matches_oracle_and_reference(solved, mode, pc):
    u_ref, out = solved
    got, want = out[mode, pc]
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    scale = np.abs(u_ref).max()
    np.testing.assert_allclose(got.u_global, u_ref, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(got.lam, np.asarray(want.lam), rtol=0,
                               atol=1e-9 * np.abs(want.lam).max())
    np.testing.assert_allclose(got.alpha, np.asarray(want.alpha), rtol=0,
                               atol=1e-9 * max(np.abs(want.alpha).max(), 1.0))


@pytest.mark.parametrize("extra", [
    ["--kernels"], ["--mode", "implicit", "--precond", "none"]])
def test_launcher_cpu_smoke(extra, capsys):
    rc = solve_feti.main(["--arch", "feti-heat-2d", "--smoke", "--device",
                          "cpu", "--validate", *extra])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "converged=True" in out and "rel err vs global solve" in out
