"""Architecture registry: ``--arch <id>`` resolution for the FETI and the
serving launchers (counterpart of ``repro.configs.registry``).

Each config module registers a full-size config and a reduced smoke config
used by the CPU tests: a FetiArchConfig for the paper's FETI problems, a
:class:`~repro_torch.models.config.ModelConfig` for each of the reference's
ten language models.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Tuple

__all__ = ["register", "get_config", "get_smoke_config", "list_archs",
           "FetiArchConfig", "ARCH_MODULES"]

_FULL: Dict[str, Callable] = {}
_SMOKE: Dict[str, Callable] = {}

ARCH_MODULES = [
    "qwen2_vl_2b",
    "granite_3_8b",
    "nemotron_4_340b",
    "qwen15_32b",
    "mistral_large_123b",
    "recurrentgemma_2b",
    "rwkv6_1_6b",
    "hubert_xlarge",
    "deepseek_v2_236b",
    "grok_1_314b",
    "feti_heat_2d",
    "feti_heat_3d",
    "feti_elasticity_2d",
    "feti_elasticity_3d",
]


@dataclasses.dataclass(frozen=True)
class FetiArchConfig:
    """The paper's own 'architecture': a structured FETI problem.

    ``problem`` selects the workload: scalar "heat" (1 DOF/node, kernel
    dim 1) or vector "elasticity" (2-3 DOFs/node, rigid-body kernel dim
    3/6)."""

    name: str
    dim: int
    sub_grid: Tuple[int, ...]
    elems_per_sub: Tuple[int, ...]
    block_size: int = 128
    rhs_block_size: int = 128
    trsm_variant: str = "factor_split"
    syrk_variant: str = "input_split"
    problem: str = "heat"
    family: str = "feti"


def register(name: str, full: Callable, smoke: Callable) -> None:
    _FULL[name] = full
    _SMOKE[name] = smoke


def _ensure_loaded() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    _ensure_loaded()
    if name not in _FULL:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_FULL)}")
    return _FULL[name]()


def get_smoke_config(name: str):
    _ensure_loaded()
    if name not in _SMOKE:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_SMOKE)}")
    return _SMOKE[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_FULL)
