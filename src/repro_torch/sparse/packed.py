"""Packed block-sparse storage: the symbolic fill mask AS the layout
(counterpart of ``repro.sparse.packed``).

A matrix lives as a stacked ``(..., n_blocks, bs, bs)`` value tensor plus a
static host-side block index, so memory is O(nnz_blocks · bs²) instead of
O(n²) per subdomain. The unregularized stiffness K of the lumped
preconditioner is always stored this way; with
``SchurAssemblyConfig(storage="packed")`` the Cholesky factors are too,
computed in the layout by :func:`block_cholesky_packed` and applied by
:func:`packed_tri_solve`, so no dense (S, n, n) stack is ever built.

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
from typing import Optional

import numpy as np
import torch

__all__ = [
    "PackedBlockIndex",
    "PackedBlocks",
    "pack_factor",
    "block_cholesky_packed",
    "packed_tri_solve",
    "packed_symm_matvec",
    "packed_block_index_for",
]


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
        self._device_cache: dict = {}

    @classmethod
    def from_mask(cls, mask: np.ndarray, n: int, bs: int) -> "PackedBlockIndex":
        """Index from a symbolic block fill mask (block_symbolic_cholesky)."""
        return cls(mask, n, bs)

    @classmethod
    def full(cls, n: int, bs: int) -> "PackedBlockIndex":
        """All lower-triangular blocks present (no sparsity information)."""
        nb = -(-n // bs)
        return cls(np.tril(np.ones((nb, nb), dtype=bool)), n, bs)

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

    def slot(self, i: int, j: int) -> int:
        """Slot of block (i, j); raises KeyError when structurally absent."""
        s = int(self.slot_table[i, j])
        if s < 0:
            raise KeyError(f"block ({i},{j}) not in packed layout")
        return s

    def row_slots(self, k: int) -> list[tuple[int, int]]:
        """[(j, slot)] of the strictly-subdiagonal blocks in row k (j < k)."""
        lo, hi = int(self.rowptr[k]), int(self.rowptr[k + 1]) - 1
        return [(int(self.cols[t]), t) for t in range(lo, hi)]

    def col_slots(self, k: int) -> list[tuple[int, int]]:
        """[(i, slot)] of the strictly-subdiagonal blocks in column k (i > k)."""
        col = self.slot_table[k + 1:, k]
        return [(k + 1 + i, int(s)) for i, s in enumerate(col) if s >= 0]

    def packed_nbytes(self, dtype_bytes: int = 8) -> int:
        """Device bytes of ONE packed matrix's value array."""
        return self.n_blocks * self.bs * self.bs * dtype_bytes

    def dense_nbytes(self, dtype_bytes: int = 8) -> int:
        """Device bytes of the dense (n, n) array this layout replaces."""
        return self.n * self.n * dtype_bytes

    def validate(self, values) -> None:
        """Shape-check a value array (batched or not) against this index."""
        shape = tuple(values.shape)
        if len(shape) < 3 or shape[-3:] != (self.n_blocks, self.bs, self.bs):
            raise ValueError(
                f"values shape {shape} does not end in "
                f"({self.n_blocks}, {self.bs}, {self.bs})")

    def _blocks(self):
        """(slot, row range, column range) of every stored block, trimmed
        to the unpadded n."""
        bs, n = self.bs, self.n
        for t, (i, j) in enumerate(zip(self.rows.tolist(), self.cols.tolist())):
            yield t, (i * bs, min((i + 1) * bs, n)), (j * bs, min((j + 1) * bs, n))

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
        out = A.new_zeros(lead + (self.n_blocks, self.bs, self.bs))
        for t, (i0, i1), (j0, j1) in self._blocks():
            out[..., t, : i1 - i0, : j1 - j0] = A[..., i0:i1, j0:j1]
        if diag_identity_pad:
            self.set_identity_pad(out)
        return out

    def set_identity_pad(self, values: torch.Tensor) -> None:
        """Put 1s on the padded tail of the last diagonal block, in place."""
        pad = self.n_pad - self.n
        if pad:
            idx = torch.arange(self.bs - pad, self.bs, device=values.device)
            values[..., int(self.diag_slots[-1]), idx, idx] = 1.0

    def flat_gather(self, perm: np.ndarray, n_src: Optional[int] = None
                    ) -> np.ndarray:
        """(n_blocks·bs·bs,) int64 positions that pack ``A[perm][:, perm]``
        straight from a flattened (n_src·n_src,) ``A`` with one zero
        appended.

        ``values.view(-1) = A_ext[flat_gather(perm)]`` with
        ``A_ext = cat([A.reshape(-1), [0]])``: padded entries point at the
        appended zero. The permutation costs no copy of A. ``perm`` has
        ``n`` entries; ``n_src`` (default ``n``) is A's size, larger when
        ``perm`` selects a principal submatrix of A.
        """
        n, bs = self.n, self.bs
        n_src = n if n_src is None else n_src
        p_pad = np.concatenate([np.asarray(perm, dtype=np.int64),
                                np.full(self.n_pad - n, -1)])
        r = p_pad[(self.rows[:, None].astype(np.int64) * bs + np.arange(bs))]
        c = p_pad[(self.cols[:, None].astype(np.int64) * bs + np.arange(bs))]
        flat = r[:, :, None] * n_src + c[:, None, :]
        flat[(r[:, :, None] < 0) | (c[:, None, :] < 0)] = n_src * n_src
        return flat.reshape(-1)

    def unpack(self, values: torch.Tensor) -> torch.Tensor:
        """Scatter (..., n_blocks, bs, bs) values back to dense (..., n, n).

        Unstored blocks come back as exact zeros; the padded tail
        (including any identity diagonal padding) is trimmed away.
        """
        self.validate(values)
        lead = values.shape[:-3]
        out = values.new_zeros(lead + (self.n, self.n))
        for t, (i0, i1), (j0, j1) in self._blocks():
            out[..., i0:i1, j0:j1] = values[..., t, : i1 - i0, : j1 - j0]
        return out

    def device_plan(self, device: torch.device) -> dict:
        """Index tensors of the batched packed algorithms on ``device``,
        built once per device: each row's strictly-lower block columns, the
        slots' coordinates and the matvec's segment-sum plan."""
        key = str(device)
        plan = self._device_cache.get(key)
        if plan is None:
            as_t = lambda a: torch.as_tensor(  # noqa: E731
                np.asarray(a, dtype=np.int64), device=device)
            plan = {
                "row_cols": [as_t(self.cols[self.rowptr[k]:self.rowptr[k + 1] - 1])
                             for k in range(self.nb)],
                "rows": as_t(self.rows),
                "cols": as_t(self.cols),
                "matvec_gather": as_t(self._matvec_gather),
            }
            self._device_cache[key] = plan
        return plan

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

    def to(self, dtype: torch.dtype) -> "PackedBlocks":
        """The same matrices with values at ``dtype`` (``self`` when they
        already are)."""
        if self.values.dtype == dtype:
            return self
        return PackedBlocks(self.values.to(dtype), self.index)

    def unpack(self) -> torch.Tensor:
        return self.index.unpack(self.values)


def pack_factor(L: torch.Tensor, index: PackedBlockIndex) -> PackedBlocks:
    """Pack a dense lower-triangular factor (..., n, n) into the layout,
    identity-padding the diagonal tail so every diagonal block stays
    triangular-invertible."""
    return PackedBlocks(index.pack(L, diag_identity_pad=True), index)


def _solve_lower_right(Lkk: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Solve X Lkkᵀ = W for X (i.e. X = W Lkk⁻ᵀ), batched."""
    return torch.linalg.solve_triangular(Lkk.mT, W, upper=True, left=False)


# bytes of f64 transients one chunk of block_cholesky_packed's reduced-
# precision trailing update may take
_CHUNK_BYTES = 256 << 20


def block_cholesky_packed(K, index: PackedBlockIndex) -> PackedBlocks:
    """Cholesky factors of an SPD stack, computed AND stored in packed form.

    Args:
      K: (S, n, n) dense SPD stack (packed first, identity-padded), or a
        :class:`PackedBlocks` of it whose (S, n_blocks, bs, bs) values are
        factorized IN PLACE — the preprocessor packs K straight from the
        host, so no dense stack ever exists.
      index: the layout; its mask must contain the symbolic fill.

    The numerical twin of :func:`repro_torch.sparse.cholesky.block_cholesky`
    with ``mask=index.mask``, batched over S: per block column k, one
    ``cholesky_ex`` of the diagonal slot, one solve of every stored panel
    slot below it, and one batched update of the target slots (i, j <= i).
    Within one k step the targets are distinct, so the indexed update is
    deterministic. Below f64 every step runs at f64 on the stored blocks
    and rounds what it writes, as the dense twin does (its module note
    says why); the trailing update then goes in chunks of target slots.
    Raises ``ValueError`` if a diagonal block is not positive definite.
    """
    if isinstance(K, PackedBlocks):
        if K.index is not index:
            raise ValueError("K is packed with another index")
        vals = K.values
    else:
        vals = index.pack(K, diag_identity_pad=True)
    index.validate(vals)
    if vals.dim() != 4:
        raise ValueError(f"expected an (S, n_blocks, bs, bs) stack, got "
                         f"{tuple(vals.shape)}")
    dev = vals.device
    wide = vals.dtype != torch.float64
    # target slots per chunk of the reduced-precision trailing update: its
    # f64 transients (the gathered panel pairs, the product and the targets
    # at f64) stay near _CHUNK_BYTES
    chunk = max(1, _CHUNK_BYTES // (4 * 8 * vals.shape[0] * index.bs ** 2))
    infos = []
    for k in range(index.nb):
        dk = int(index.diag_slots[k])
        Lkk, info = torch.linalg.cholesky_ex(vals[:, dk].to(torch.float64))
        infos.append(info)
        vals[:, dk] = Lkk
        below = index.col_slots(k)
        if not below:
            continue
        slots = torch.as_tensor([s for _, s in below], device=dev)
        panels = _solve_lower_right(Lkk[:, None],
                                    vals[:, slots].to(torch.float64))
        vals[:, slots] = panels.to(vals.dtype)
        # symbolic fill guarantees (i, j) is stored: i, j share column k
        a, b = np.tril_indices(len(below))
        targets = [index.slot(below[x][0], below[y][0]) for x, y in zip(a, b)]
        a_t = torch.as_tensor(a, device=dev)
        b_t = torch.as_tensor(b, device=dev)
        t_t = torch.as_tensor(targets, device=dev)
        if not wide:
            vals[:, t_t] -= panels[:, a_t] @ panels[:, b_t].mT
            continue
        for c0 in range(0, len(targets), chunk):
            c = slice(c0, c0 + chunk)
            vals[:, t_t[c]] = (vals[:, t_t[c]].to(torch.float64)
                               - panels[:, a_t[c]] @ panels[:, b_t[c]].mT
                               ).to(vals.dtype)
    if bool(torch.stack(infos).ne(0).any()):
        raise ValueError("block_cholesky_packed: a diagonal block is not "
                         "positive definite")
    return PackedBlocks(vals, index)


def _tri_solve(L: torch.Tensor, b: torch.Tensor, upper: bool) -> torch.Tensor:
    """Batched triangular solve of an (S, bs) vector or (S, bs, r) block."""
    if b.dim() == 2:
        return torch.linalg.solve_triangular(L, b.unsqueeze(-1),
                                             upper=upper).squeeze(-1)
    return torch.linalg.solve_triangular(L, b, upper=upper)


def packed_tri_solve(pb: PackedBlocks, b: torch.Tensor,
                     transpose: bool = False) -> torch.Tensor:
    """Solve ``L_s x_s = b_s`` (or ``L_sᵀ x_s = b_s``) for a packed factor
    stack; ``b`` is (S, n) or an (S, n, n_rhs) column block, and ``x`` has
    its shape.

    Forward: block rows in order, each row's stored blocks in one product
    (its slots are contiguous, so the values are read in place). Transpose:
    block rows in reverse; once ``x_k`` is solved, row k's stored blocks
    push ``L_kjᵀ x_k`` into the pending ``x_j`` (distinct j, so the indexed
    update is deterministic) — the values are again read in place. A
    column block takes the same walk, each block step one product over
    every column.
    """
    index = pb.index
    vals = pb.values
    S, cols = b.shape[0], b.shape[2:]
    n, bs, nb = index.n, index.bs, index.nb
    plan = index.device_plan(b.device)
    x = b.new_zeros((S, nb, bs) + cols)
    x.view((S, -1) + cols)[:, :n] = b
    ks = range(nb - 1, -1, -1) if transpose else range(nb)
    for k in ks:
        t0, t1 = int(index.rowptr[k]), int(index.rowptr[k + 1]) - 1
        row_cols = plan["row_cols"][k]
        Lkk = vals[:, t1]
        if not transpose:
            acc = x[:, k]
            if t1 > t0:
                acc = acc - torch.einsum("stab,stb...->sa...",
                                         vals[:, t0:t1], x[:, row_cols])
            x[:, k] = _tri_solve(Lkk, acc, upper=False)
            continue
        xk = _tri_solve(Lkk.mT, x[:, k], upper=True)
        x[:, k] = xk
        if t1 > t0:
            x[:, row_cols] -= torch.einsum("stab,sa...->stb...",
                                           vals[:, t0:t1], xk)
    return x.reshape((S, -1) + cols)[:, :n]


def packed_symm_matvec(pb: PackedBlocks, v: torch.Tensor) -> torch.Tensor:
    """``A_s @ v_s`` for a stack of symmetric matrices stored as their packed
    lower triangles; ``v`` is (S, n) or an (S, n, n_rhs) column block,
    ``pb.values`` (S, n_blocks, bs, bs).

    Two batched products over all stored blocks (each block and its
    transpose; the diagonal blocks' transposed products go unused, which
    is cheaper than gathering a copy of the strictly-lower blocks), then
    every block row sums its products through a precomputed gather — the
    result does not depend on atomic ordering, as an ``index_add_`` on the
    card would.
    """
    index = pb.index
    S, cols = v.shape[0], v.shape[2:]
    n, bs, nb = index.n, index.bs, index.nb
    plan = index.device_plan(v.device)
    pad = (0, 0) * len(cols) + (0, index.n_pad - n)
    vb = torch.nn.functional.pad(v, pad).reshape((S, nb, bs) + cols)
    lower = torch.einsum("sbij,sbj...->sbi...", pb.values, vb[:, plan["cols"]])
    upper = torch.einsum("sbji,sbj...->sbi...", pb.values, vb[:, plan["rows"]])
    contrib = torch.cat([lower, upper, lower.new_zeros((S, 1, bs) + cols)],
                        dim=1)
    out = contrib[:, plan["matvec_gather"]].sum(dim=2)  # (S, nb, bs, ...)
    return out.reshape((S, -1) + cols)[:, :n]


def packed_block_index_for(mask: Optional[np.ndarray], n: int, bs: int
                           ) -> PackedBlockIndex:
    """Index from a fill mask, or the full lower triangle when no symbolic
    information is available (packed storage then still works — it is just
    not smaller than dense)."""
    if mask is None:
        return PackedBlockIndex.full(n, bs)
    return PackedBlockIndex.from_mask(mask, n, bs)
