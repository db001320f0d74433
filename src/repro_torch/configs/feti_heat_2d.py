"""feti-heat-2d — the paper's own benchmark problem (§4): 2D heat transfer
on the unit square, uniform triangles, total-FETI decomposition, SC
assembly with the sparsity-utilizing pipeline."""
from repro_torch.configs.registry import FetiArchConfig, register


def config() -> FetiArchConfig:
    # production-scale cluster slice: 8x8 subdomains of 64x64 elements
    # (4225 unknowns each; the paper sweeps 1k..70k)
    return FetiArchConfig(
        name="feti-heat-2d",
        dim=2,
        sub_grid=(8, 8),
        elems_per_sub=(64, 64),
        block_size=128,
        rhs_block_size=128,
        trsm_variant="factor_split",
        syrk_variant="input_split",
    )


def smoke_config() -> FetiArchConfig:
    return FetiArchConfig(
        name="feti-heat-2d-smoke",
        dim=2,
        sub_grid=(2, 2),
        elems_per_sub=(4, 4),
        block_size=8,
        rhs_block_size=8,
    )


register("feti-heat-2d", config, smoke_config)
