"""Distribution substrate of the LM path (counterpart of
``repro.distributed``): sharding rules (DP/FSDP/TP/EP/SP) as per-dimension
specs with DTensor placements on a ``DeviceMesh``, atomic checkpoints with
keep-last-k pruning, straggler monitoring and elastic restart plans,
gradient compression."""
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
from repro_torch.distributed.sharding import (
    batch_shardings,
    batch_spec,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
)

__all__ = [
    "ElasticPlan",
    "StepTimer",
    "StragglerMonitor",
    "available_steps",
    "batch_shardings",
    "batch_spec",
    "bf16_compress",
    "cache_shardings",
    "latest_step",
    "make_int8_error_feedback",
    "opt_state_shardings",
    "param_shardings",
    "restore_checkpoint",
    "save_checkpoint",
]
