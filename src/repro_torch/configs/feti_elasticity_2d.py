"""feti-elasticity-2d — the paper's target engineering workload: 2D linear
elasticity (plane strain, 2 DOFs per node) on the unit square, uniform
triangles, total-FETI with rigid-body-mode kernels (k = 3). The companion
CUDA work (Homola et al., arXiv:2502.08382) benchmarks exactly this
setting in ESPRESO."""
from repro_torch.configs.registry import FetiArchConfig, register


def config() -> FetiArchConfig:
    # 4x4 subdomains of 32x32 elements (~2.2k DOFs each: the node-blocked
    # 2-DOF expansion of a ~1.1k-node heat subdomain)
    return FetiArchConfig(
        name="feti-elasticity-2d",
        dim=2,
        sub_grid=(4, 4),
        elems_per_sub=(32, 32),
        block_size=128,
        rhs_block_size=128,
        trsm_variant="factor_split",
        syrk_variant="input_split",
        problem="elasticity",
    )


def smoke_config() -> FetiArchConfig:
    return FetiArchConfig(
        name="feti-elasticity-2d-smoke",
        dim=2,
        sub_grid=(2, 2),
        elems_per_sub=(4, 4),
        block_size=8,
        rhs_block_size=8,
        problem="elasticity",
    )


register("feti-elasticity-2d", config, smoke_config)
