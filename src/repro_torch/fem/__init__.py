"""P1 finite elements and the total-FETI decomposition of the heat problem
(host-side numpy)."""
from repro_torch.fem.assembly import (
    assemble_dense,
    assemble_scipy_csr,
    load_vector,
    p1_element_stiffness,
)
from repro_torch.fem.decomposition import (
    FetiProblem,
    SubdomainData,
    decompose_problem,
)
from repro_torch.fem.meshgen import Mesh, structured_mesh
from repro_torch.fem.regularization import (
    fixing_dofs_regularization,
    kernel_basis,
)

__all__ = [
    "FetiProblem",
    "Mesh",
    "SubdomainData",
    "assemble_dense",
    "assemble_scipy_csr",
    "decompose_problem",
    "fixing_dofs_regularization",
    "kernel_basis",
    "load_vector",
    "p1_element_stiffness",
    "structured_mesh",
]
