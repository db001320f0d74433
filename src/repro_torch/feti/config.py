"""The front-door configuration of the port's FETI pipeline (the subset of
``repro.feti.config.FetiConfig`` the port runs, plus ``device``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.core import precision
from repro_torch.core.schur import SchurAssemblyConfig

__all__ = ["FetiConfig", "as_feti_config"]

_MODES = ("explicit", "implicit")
_PRECONDITIONERS = ("lumped", "dirichlet", "none")
_ORDERINGS = ("nd", "rcm", "natural")
_STORAGES = (None, "dense", "packed")
_SHARE = ("auto", True, False)
_MEASURES = ("auto", "never", "model")


@dataclasses.dataclass(frozen=True)
class FetiConfig:
    """Everything the port's FETI pipeline is parameterized by.

    Attributes:
      schur: the Schur-assembly configuration, ``"auto"`` (the stage graph
        plans every assembly stage jointly through the autotuner:
        :class:`repro_torch.core.stages.StageGraph`), or ``None`` for
        defaults.
      mode: ``"explicit"`` assembles the dual operators F̃ up front
        (paper eq. 12); ``"implicit"`` applies them factor-backed (eq. 11).
      preconditioner: ``"lumped"`` | ``"dirichlet"`` | ``"none"``.
        ``"dirichlet"`` adds the primal boundary-Schur stage S_b to
        preprocessing (:mod:`repro_torch.feti.dirichlet`), assembled with
        the dual stage's Schur config (under ``"auto"``, its own plan).
      ordering: fill-reducing node ordering ("nd" | "rcm" | "natural").
      measure: the autotuner's measurement policy under ``schur="auto"``:
        ``"auto"`` times the model's best candidates on the stage's
        device, ``"never"``/``"model"`` ranks by the roofline model alone.
      plan_cache: consult/populate the content-addressed plan cache
        (``$REPRO_TORCH_PLAN_CACHE_DIR``).
      storage: factor storage override ("dense" | "packed"); ``None``
        defers to ``schur.storage``.
      dtype: storage dtype of the numeric stacks: ``torch.float64`` (the
        default), ``torch.float32``/``"f32"``, or ``torch.bfloat16``/
        ``"bf16"`` (storage only: the prep runs at f32 and rounds its
        outputs). Reduced precision halves (f32) or quarters (bf16) the
        factor, F̃ and S_b stacks; f64 accuracy comes back through
        ``refine``. Every kernel, the fused ones too, runs at f32 for
        f32 and bf16 storage.
      refine: iterative-refinement steps around the interior solves when
        the storage dtype is reduced (and, in explicit mode, f64
        defect-correction outer iterations against the reduced-precision
        F̃). ``None`` resolves to 0 for f64 and 2 otherwise; 0 disables
        recovery. Ignored (kept 0) for f64 stacks.
      device: where the stacks live and the work runs; ``None`` means
        ``cuda`` (see :func:`repro_torch.device.resolve_device`).
      share_factor: dedupe the interior factorization between the dual
        and Dirichlet stages. ``"auto"`` shares whenever valid (every
        subdomain's fixing DOFs lie on the boundary, so the regularization
        cannot perturb the shared interior factor); ``True`` requires it
        (preprocessing raises if invalid); ``False`` keeps the two
        factorizations apart.
      mesh: this rank's :class:`~repro_torch.launch.mesh.FetiMesh` to
        split the subdomains over ``torch.distributed`` ranks
        (:mod:`repro_torch.feti.sharded`); ``None`` runs every subdomain on
        one device. Under a mesh ``device`` is the mesh's (``None`` takes
        it; another device type raises).
    """

    schur: Union[SchurAssemblyConfig, str, None] = None
    mode: str = "explicit"
    preconditioner: str = "lumped"
    ordering: str = "nd"
    measure: str = "auto"
    plan_cache: bool = True
    storage: Optional[str] = None
    dtype: Any = torch.float64
    refine: Optional[int] = None
    device: Union[str, torch.device, None] = None
    share_factor: Union[str, bool] = "auto"
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            from repro_torch.launch.mesh import FetiMesh

            if not isinstance(self.mesh, FetiMesh):
                raise TypeError(f"mesh must be a FetiMesh or None, got "
                                f"{type(self.mesh).__name__}")
            if (self.device is not None and torch.device(self.device).type
                    != self.mesh.device.type):
                raise ValueError(f"device {self.device} is not the mesh's "
                                 f"{self.mesh.device}")
            object.__setattr__(self, "device", self.mesh.device)
        if isinstance(self.schur, str) and self.schur != "auto":
            raise ValueError("schur must be a SchurAssemblyConfig, 'auto' "
                             f"or None, got {self.schur!r}")
        if self.schur is not None and not isinstance(
                self.schur, (SchurAssemblyConfig, str)):
            raise TypeError("schur must be a SchurAssemblyConfig, 'auto' "
                            "or None")
        if self.measure not in _MEASURES:
            raise ValueError(f"measure must be one of {_MEASURES}, "
                             f"got {self.measure!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.preconditioner not in _PRECONDITIONERS:
            raise ValueError(f"preconditioner must be one of "
                             f"{_PRECONDITIONERS}, got {self.preconditioner!r}")
        if self.ordering not in _ORDERINGS:
            raise ValueError(f"ordering must be one of {_ORDERINGS}")
        if self.storage not in _STORAGES:
            raise ValueError(f"storage must be one of {_STORAGES}, "
                             f"got {self.storage!r}")
        if self.share_factor not in _SHARE:
            raise ValueError(f"share_factor must be one of {_SHARE}, "
                             f"got {self.share_factor!r}")
        precision.canonical_dtype(self.dtype)  # raises on unsupported dtypes
        if self.refine is not None and (
                not isinstance(self.refine, int) or self.refine < 0):
            raise ValueError(f"refine must be None or a non-negative int, "
                             f"got {self.refine!r}")
        if self.storage_dtype == torch.bfloat16 and self.resolved_refine() == 0:
            raise ValueError(
                "bf16 storage needs refine >= 1: without refinement the PCPG "
                "vectors would be bf16, and torch (like the reference) has no "
                "bf16 QR for the coarse problem")

    def replace(self, **changes) -> "FetiConfig":
        """A copy with ``changes`` applied (``dataclasses.replace``), e.g.
        ``config.replace(mesh=None)`` for the single-device twin of a
        sharded run (on the mesh's device); validated as a new config."""
        return dataclasses.replace(self, **changes)

    @property
    def explicit(self) -> bool:
        return self.mode == "explicit"

    @property
    def dirichlet(self) -> bool:
        """Whether preprocessing assembles the Dirichlet stage."""
        return self.preconditioner == "dirichlet"

    @property
    def auto(self) -> bool:
        """Whether preprocessing plans the Schur configs (``schur="auto"``)."""
        return self.schur == "auto"

    # -- the precision axis -------------------------------------------------

    @property
    def storage_dtype(self) -> torch.dtype:
        """Torch dtype of the stored stacks (the reference's ``dtype_np``)."""
        return precision.canonical_dtype(self.dtype)

    @property
    def dtype_name(self) -> str:
        """Short name of the storage dtype: "f64" | "f32" | "bf16"."""
        return precision.dtype_name(self.dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype of the factorization, TRSM and SYRK (bf16 runs at f32)."""
        return precision.compute_dtype(self.dtype)

    @property
    def reduced(self) -> bool:
        """True when the stacks are stored below f64."""
        return self.storage_dtype != torch.float64

    def resolved_refine(self) -> int:
        """Refinement steps with the dtype's default applied (f64: 0;
        reduced: 2 unless overridden)."""
        if not self.reduced:
            return 0
        if self.refine is None:
            return precision.default_refine_steps(self.dtype)
        return self.refine

    @property
    def solve_dtype(self) -> torch.dtype:
        """Dtype of the PCPG vectors, loads and kernel bases: f64 whenever
        refinement recovers f64 accuracy, else the storage dtype."""
        return precision.solve_dtype(self.dtype, self.resolved_refine())

    def resolved_schur(self) -> SchurAssemblyConfig:
        """The Schur config of a run that does not autotune, with
        ``storage`` overriding its storage; ``"auto"`` raises (it resolves
        during preprocessing)."""
        if self.auto:
            raise ValueError("schur='auto' resolves during preprocessing")
        cfg = self.schur if self.schur is not None else SchurAssemblyConfig()
        if self.storage is not None and self.storage != cfg.storage:
            cfg = dataclasses.replace(cfg, storage=self.storage)
        return cfg


def as_feti_config(config: Optional[FetiConfig]) -> FetiConfig:
    """``config``, or the defaults for ``None``."""
    if config is None:
        return FetiConfig()
    if isinstance(config, FetiConfig):
        return config
    raise TypeError(f"config must be a FetiConfig or None, got "
                    f"{type(config).__name__}")
