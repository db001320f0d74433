"""The paper's FETI problems and the language models of the serving path,
selectable via ``--arch <id>``."""
from repro_torch.configs.registry import (
    FetiArchConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)

__all__ = ["FetiArchConfig", "get_config", "get_smoke_config", "list_archs",
           "register"]
