"""The front-door configuration of the port's FETI pipeline (the subset of
``repro.feti.config.FetiConfig`` this slice runs, plus ``device``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.schur import SchurAssemblyConfig

__all__ = ["FetiConfig", "as_feti_config"]

_MODES = ("explicit", "implicit")
_PRECONDITIONERS = ("lumped", "none")
_ORDERINGS = ("nd", "rcm", "natural")


@dataclasses.dataclass(frozen=True)
class FetiConfig:
    """Everything the port's FETI pipeline is parameterized by.

    Attributes:
      schur: the Schur-assembly configuration, or ``None`` for defaults.
        ``"auto"`` (the autotuner and stage graph) is ROADMAP item A14.
      mode: ``"explicit"`` assembles the dual operators F̃ up front
        (paper eq. 12); ``"implicit"`` applies them factor-backed (eq. 11).
      preconditioner: ``"lumped"`` | ``"none"``; ``"dirichlet"`` is ROADMAP
        item A11.
      ordering: fill-reducing node ordering ("nd" | "rcm" | "natural").
      dtype: storage dtype; float64 only (mixed precision is ROADMAP A13).
      device: where the stacks live and the work runs; ``None`` means
        ``cuda`` (see :func:`repro_torch.device.resolve_device`).
    """

    schur: Optional[SchurAssemblyConfig] = None
    mode: str = "explicit"
    preconditioner: str = "lumped"
    ordering: str = "nd"
    dtype: torch.dtype = torch.float64
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.schur == "auto":
            raise NotImplementedError(
                "schur='auto' (autotuner + stage graph) is ROADMAP item A14")
        if self.schur is not None and not isinstance(self.schur,
                                                     SchurAssemblyConfig):
            raise TypeError("schur must be a SchurAssemblyConfig or None")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.preconditioner == "dirichlet":
            raise NotImplementedError(
                "the Dirichlet preconditioner is ROADMAP item A11")
        if self.preconditioner not in _PRECONDITIONERS:
            raise ValueError(f"preconditioner must be one of "
                             f"{_PRECONDITIONERS}, got {self.preconditioner!r}")
        if self.ordering not in _ORDERINGS:
            raise ValueError(f"ordering must be one of {_ORDERINGS}")
        if self.dtype != torch.float64:
            raise NotImplementedError(
                "storage below float64 (mixed precision) is ROADMAP item A13")

    @property
    def explicit(self) -> bool:
        return self.mode == "explicit"

    def resolved_schur(self) -> SchurAssemblyConfig:
        return self.schur if self.schur is not None else SchurAssemblyConfig()


def as_feti_config(config: Optional[FetiConfig]) -> FetiConfig:
    """``config``, or the defaults for ``None``."""
    if config is None:
        return FetiConfig()
    if isinstance(config, FetiConfig):
        return config
    raise TypeError(f"config must be a FetiConfig or None, got "
                    f"{type(config).__name__}")
