"""P1 finite elements and the total-FETI decomposition of the heat and
linear-elasticity problems (host-side numpy)."""
from repro_torch.fem.assembly import (
    assemble_dense,
    assemble_scipy_csr,
    elasticity_load_vector,
    elasticity_matrix,
    element_dofs,
    load_vector,
    p1_elasticity_stiffness,
    p1_element_stiffness,
)
from repro_torch.fem.decomposition import (
    FetiProblem,
    SubdomainData,
    decompose_elasticity_problem,
    decompose_problem,
)
from repro_torch.fem.meshgen import Mesh, structured_mesh
from repro_torch.fem.regularization import (
    fixing_dofs_regularization,
    kernel_basis,
    rigid_body_modes,
)

__all__ = [
    "FetiProblem",
    "Mesh",
    "SubdomainData",
    "assemble_dense",
    "assemble_scipy_csr",
    "decompose_elasticity_problem",
    "decompose_problem",
    "elasticity_load_vector",
    "elasticity_matrix",
    "element_dofs",
    "fixing_dofs_regularization",
    "kernel_basis",
    "load_vector",
    "p1_elasticity_stiffness",
    "p1_element_stiffness",
    "rigid_body_modes",
    "structured_mesh",
]
