"""Architecture registry: ``--arch <id>`` resolution for the FETI launcher
(counterpart of ``repro.configs.registry``, FETI part only).

Each config module registers a full-size FetiArchConfig and a reduced
smoke FetiArchConfig used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Tuple

__all__ = ["register", "get_config", "get_smoke_config", "list_archs",
           "FetiArchConfig", "ARCH_MODULES"]

_FULL: Dict[str, Callable] = {}
_SMOKE: Dict[str, Callable] = {}

ARCH_MODULES = ["feti_heat_2d"]


@dataclasses.dataclass(frozen=True)
class FetiArchConfig:
    """The paper's own 'architecture': a structured FETI problem."""

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


def get_config(name: str) -> FetiArchConfig:
    _ensure_loaded()
    if name not in _FULL:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_FULL)}")
    return _FULL[name]()


def get_smoke_config(name: str) -> FetiArchConfig:
    _ensure_loaded()
    if name not in _SMOKE:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_SMOKE)}")
    return _SMOKE[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_FULL)
