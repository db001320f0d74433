"""The paper's FETI problems, selectable via ``--arch <id>``."""
from repro_torch.configs.registry import (
    FetiArchConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)

__all__ = ["FetiArchConfig", "get_config", "get_smoke_config", "list_archs",
           "register"]
