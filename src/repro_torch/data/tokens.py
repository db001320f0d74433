"""Memmap token-file pipeline (counterpart of ``repro.data.tokens``): a
flat binary corpus to sharded, shuffled, fixed-length LM batches.

The file format is the reference's: a 16-byte header (magic ``RP01``,
the token width code, the count's low and high 32 bits) and the tokens
as uint16 (or uint32 when a token needs it). Per-host sharding keys off
``(host_id, num_hosts)``: the hosts stride one shuffled order of windows,
so each reads a disjoint stream.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["write_token_file", "TokenFileDataset"]

_MAGIC = np.uint32(0x52503031)  # "RP01"


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1-D, not {tokens.shape}")
    dtype = np.uint32 if tokens.max(initial=0) >= 2**16 else np.uint16
    header = np.array([_MAGIC, np.uint32(1 if dtype == np.uint16 else 2),
                       np.uint32(len(tokens) & 0xFFFFFFFF),
                       np.uint32(len(tokens) >> 32)], np.uint32)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(tokens.astype(dtype).tobytes())


class TokenFileDataset:
    """Iterates ``{"tokens", "labels"}`` batches of (batch_size, seq_len)
    int32 CPU tensors from a flat token file; labels are the tokens
    shifted by one."""

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0):
        header = np.fromfile(path, np.uint32, count=4)
        if header[0] != _MAGIC:
            raise ValueError(f"{path}: bad magic {header[0]:#x}")
        dtype = np.uint16 if header[1] == 1 else np.uint32
        count = int(header[2]) | (int(header[3]) << 32)
        self._data = np.memmap(path, dtype, mode="r", offset=16,
                               shape=(count,))
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.n_windows = (count - 1) // seq_len

    def __iter__(self) -> Iterator[dict]:
        order = np.random.default_rng(self.seed).permutation(self.n_windows)
        order = order[self.host_id::self.num_hosts]  # disjoint per host
        bs, sl = self.batch_size, self.seq_len
        for i in range(0, len(order) - bs + 1, bs):
            toks = np.stack([self._data[j * sl:j * sl + sl + 1]
                             for j in order[i:i + bs]]).astype(np.int32)
            yield {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                   "labels": torch.from_numpy(toks[:, 1:].copy())}
