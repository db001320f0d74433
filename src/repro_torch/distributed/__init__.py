"""Distribution substrate of the LM training path (counterpart of
``repro.distributed``): atomic checkpoints with keep-last-k pruning,
straggler monitoring and elastic restart plans, gradient compression.

The reference's GSPMD sharding rules (``sharding.py``, ``actsharding.py``)
have no counterpart here yet: their placements over ranks belong with the
LM meshes (ROADMAP A18d)."""
from repro_torch.distributed.checkpoint import (
    available_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.distributed.compression import (
    bf16_compress,
    make_int8_error_feedback,
)
from repro_torch.distributed.elastic import (
    ElasticPlan,
    StepTimer,
    StragglerMonitor,
)

__all__ = [
    "ElasticPlan",
    "StepTimer",
    "StragglerMonitor",
    "available_steps",
    "bf16_compress",
    "latest_step",
    "make_int8_error_feedback",
    "restore_checkpoint",
    "save_checkpoint",
]
