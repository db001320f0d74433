"""Serving steps of the LM path (counterpart of ``repro.train``'s serve
steps). The optimizer and ``train_step`` wait for ROADMAP A18c."""
from repro_torch.train.serve_step import (
    greedy_generate,
    make_decode_step,
    make_prefill_step,
)

__all__ = ["greedy_generate", "make_decode_step", "make_prefill_step"]
