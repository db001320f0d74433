"""feti-heat-3d — the paper's own benchmark problem (§4): 3D heat transfer
on the unit cube, uniform tetrahedra, total-FETI decomposition. 3D is where
the paper reports its headline speedups (5.1x kernel / 3.3x assembly)."""
from repro_torch.configs.registry import FetiArchConfig, register


def config() -> FetiArchConfig:
    # 4x4x4 subdomains of 16^3 elements (~4.9k unknowns each)
    return FetiArchConfig(
        name="feti-heat-3d",
        dim=3,
        sub_grid=(4, 4, 4),
        elems_per_sub=(16, 16, 16),
        block_size=128,
        rhs_block_size=128,
        trsm_variant="factor_split",
        syrk_variant="input_split",
    )


def smoke_config() -> FetiArchConfig:
    return FetiArchConfig(
        name="feti-heat-3d-smoke",
        dim=3,
        sub_grid=(2, 2, 1),
        elems_per_sub=(3, 3, 3),
        block_size=8,
        rhs_block_size=8,
    )


register("feti-heat-3d", config, smoke_config)
