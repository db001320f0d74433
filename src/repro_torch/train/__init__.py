"""Training and serving steps of the LM path (counterpart of
``repro.train``): AdamW, the LM loss and ``train_step`` with gradient
accumulation, and the prefill / decode serve steps."""
from repro_torch.train.optimizer import OptimizerConfig, adamw_init, adamw_update
from repro_torch.train.serve_step import (
    greedy_generate,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.train.train_step import TrainConfig, loss_fn, make_train_step

__all__ = [
    "OptimizerConfig",
    "TrainConfig",
    "adamw_init",
    "adamw_update",
    "greedy_generate",
    "loss_fn",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
]
