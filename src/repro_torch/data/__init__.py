"""Data for the LM training path (counterpart of ``repro.data``):
deterministic synthetic batches for every architecture's input contract,
and a memmap token-file pipeline with per-host sharding for real corpora.
Batches are CPU tensors; the training step moves them to the model's
device."""
from repro_torch.data.synthetic import synthetic_batch, synthetic_batches
from repro_torch.data.tokens import TokenFileDataset, write_token_file

__all__ = [
    "TokenFileDataset",
    "synthetic_batch",
    "synthetic_batches",
    "write_token_file",
]
