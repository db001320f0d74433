"""feti-elasticity-3d — 3D linear elasticity (3 DOFs per node) on the unit
cube, uniform tetrahedra, total-FETI with 6-dimensional rigid-body-mode
kernels: the hardest coarse-space setting the paper's pipeline targets,
and the natural stress case for the node-blocked packed factor storage."""
from repro_torch.configs.registry import FetiArchConfig, register


def config() -> FetiArchConfig:
    # 2x2x2 subdomains of 8^3 elements (~2.2k DOFs each)
    return FetiArchConfig(
        name="feti-elasticity-3d",
        dim=3,
        sub_grid=(2, 2, 2),
        elems_per_sub=(8, 8, 8),
        block_size=128,
        rhs_block_size=128,
        trsm_variant="factor_split",
        syrk_variant="input_split",
        problem="elasticity",
    )


def smoke_config() -> FetiArchConfig:
    return FetiArchConfig(
        name="feti-elasticity-3d-smoke",
        dim=3,
        sub_grid=(2, 2, 1),
        elems_per_sub=(2, 2, 2),
        block_size=8,
        rhs_block_size=8,
        problem="elasticity",
    )


register("feti-elasticity-3d", config, smoke_config)
