"""Packed block-sparse storage: the symbolic fill mask AS the layout
(counterpart of ``repro.sparse.packed``; the lumped-preconditioner subset).

A matrix lives as a stacked ``(..., n_blocks, bs, bs)`` value tensor plus a
static host-side block index, so memory is O(nnz_blocks · bs²) instead of
O(n²) per subdomain. This slice stores only the unregularized stiffness K
of the lumped preconditioner this way (the reference always packs it);
packed factors, ``block_cholesky_packed`` and ``packed_tri_solve`` are
ROADMAP item A9.

Layout invariants (as in the reference):

  * blocks are lower-triangular (``col <= row``) on a uniform ``bs`` grid
    padded to ``nb = ceil(n / bs)`` blocks per side;
  * slots are sorted by ``(row, col)`` so the diagonal block is the last
    slot of its row and ``rowptr`` gives each row's slot range;
  * padded rows/columns beyond ``n`` are zero (or an identity diagonal for
    factors), so every stored value is exact.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["PackedBlockIndex", "PackedBlocks", "packed_symm_matvec"]


class PackedBlockIndex:
    """Static block index of a packed lower-triangular block layout.

    Attributes:
      n: unpadded matrix dimension.
      bs: uniform block size.
      nb: blocks per side (``ceil(n / bs)``).
      rows / cols: (n_blocks,) block coordinates, sorted by (row, col).
      rowptr: (nb + 1,) CSR-style row pointers into the slot axis.
      slot_table: (nb, nb) slot of block (i, j), -1 where absent.
    """

    def __init__(self, mask: np.ndarray, n: int, bs: int):
        mask = np.asarray(mask, dtype=bool)
        nb = -(-n // bs)
        if mask.shape != (nb, nb):
            raise ValueError(f"mask shape {mask.shape} != ({nb},{nb})")
        mask = np.tril(mask).copy()
        # diagonal blocks must always exist (factorization pivots / padding)
        np.fill_diagonal(mask, True)
        rows, cols = np.nonzero(mask)  # row-major == sorted by (row, col)
        self.n = int(n)
        self.bs = int(bs)
        self.nb = int(nb)
        self.rows = rows.astype(np.int32)
        self.cols = cols.astype(np.int32)
        self.rowptr = np.concatenate(
            [[0], np.cumsum(np.bincount(rows, minlength=nb))]
        ).astype(np.int32)
        table = np.full((nb, nb), -1, dtype=np.int32)
        table[rows, cols] = np.arange(len(rows), dtype=np.int32)
        self.slot_table = table
        self.mask = mask

    @classmethod
    def from_mask(cls, mask: np.ndarray, n: int, bs: int) -> "PackedBlockIndex":
        """Index from a symbolic block fill mask (block_symbolic_cholesky)."""
        return cls(mask, n, bs)

    @property
    def n_blocks(self) -> int:
        return len(self.rows)

    @property
    def n_pad(self) -> int:
        return self.nb * self.bs

    @property
    def diag_slots(self) -> np.ndarray:
        """(nb,) slot of each diagonal block (last slot of its row)."""
        return self.rowptr[1:] - 1

    def pack(self, A: torch.Tensor, diag_identity_pad: bool = False
             ) -> torch.Tensor:
        """Gather the stored blocks of dense ``A`` (..., n, n) into
        (..., n_blocks, bs, bs) values on A's device.

        Copies block by block, so no padded (..., n_pad, n_pad) copy of A is
        ever made. ``diag_identity_pad`` puts 1s on the padded tail of the
        diagonal; the off-diagonal padding is always zero.
        """
        lead = A.shape[:-2]
        if tuple(A.shape[-2:]) != (self.n, self.n):
            raise ValueError(f"expected (..., {self.n}, {self.n}), "
                             f"got {tuple(A.shape)}")
        bs, n = self.bs, self.n
        out = A.new_zeros(lead + (self.n_blocks, bs, bs))
        for t, (i, j) in enumerate(zip(self.rows.tolist(), self.cols.tolist())):
            i0, i1 = i * bs, min((i + 1) * bs, n)
            j0, j1 = j * bs, min((j + 1) * bs, n)
            out[..., t, : i1 - i0, : j1 - j0] = A[..., i0:i1, j0:j1]
        pad = self.n_pad - n
        if pad and diag_identity_pad:
            idx = torch.arange(bs - pad, bs, device=A.device)
            out[..., int(self.diag_slots[-1]), idx, idx] = 1.0
        return out

    @functools.cached_property
    def _matvec_gather(self) -> np.ndarray:
        """Deterministic segment-sum plan of :func:`packed_symm_matvec`.

        Contributions are indexed as: slot t's product (t), slot t's
        transposed product (n_blocks + t), an appended zero (2·n_blocks).
        ``gather[r]`` lists, in slot order, the products landing in block
        row r, then the transposed strictly-lower ones, padded with the
        zero contribution.
        """
        strict = np.flatnonzero(self.rows != self.cols)
        sources = np.concatenate([np.arange(self.n_blocks),
                                  self.n_blocks + strict])
        targets = np.concatenate([self.rows, self.cols[strict]])
        order = np.argsort(targets, kind="stable")
        counts = np.bincount(targets, minlength=self.nb)
        gather = np.full((self.nb, int(counts.max())), 2 * self.n_blocks,
                         dtype=np.int64)
        pos = 0
        for r in range(self.nb):
            gather[r, : counts[r]] = sources[order[pos: pos + counts[r]]]
            pos += counts[r]
        return gather

    def __repr__(self):
        dense_blocks = self.nb * (self.nb + 1) // 2
        return (f"PackedBlockIndex(n={self.n}, bs={self.bs}, nb={self.nb}, "
                f"n_blocks={self.n_blocks}/{dense_blocks})")


@dataclasses.dataclass
class PackedBlocks:
    """A packed block-sparse matrix stack: values + static index. The
    leading batch axis, if any, lives on ``values``."""

    values: torch.Tensor  # (..., n_blocks, bs, bs)
    index: PackedBlockIndex

    @property
    def nbytes(self) -> int:
        return self.values.numel() * self.values.element_size()


def packed_symm_matvec(pb: PackedBlocks, v: torch.Tensor) -> torch.Tensor:
    """``A_s @ v_s`` for a stack of symmetric matrices stored as their packed
    lower triangles; ``v`` is (S, n), ``pb.values`` (S, n_blocks, bs, bs).

    Two batched GEMVs over all stored blocks (each block and its
    transpose; the diagonal blocks' transposed products go unused, which
    is cheaper than gathering a copy of the strictly-lower blocks), then
    every block row sums its products through a precomputed gather — the
    result does not depend on atomic ordering, as an ``index_add_`` on the
    card would.
    """
    index = pb.index
    S = v.shape[0]
    n, bs, nb = index.n, index.bs, index.nb
    vb = torch.nn.functional.pad(v, (0, index.n_pad - n)).reshape(S, nb, bs)
    rows = torch.as_tensor(index.rows, dtype=torch.long, device=v.device)
    cols = torch.as_tensor(index.cols, dtype=torch.long, device=v.device)
    lower = torch.einsum("sbij,sbj->sbi", pb.values, vb[:, cols])
    upper = torch.einsum("sbji,sbj->sbi", pb.values, vb[:, rows])
    contrib = torch.cat([lower, upper, lower.new_zeros(S, 1, bs)], dim=1)
    gather = torch.as_tensor(index._matvec_gather, device=v.device)
    out = contrib[:, gather].sum(dim=2)  # (S, nb, bs)
    return out.reshape(S, -1)[:, :n]
