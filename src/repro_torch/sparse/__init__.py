"""Sparse substrate: fill-reducing orderings, symbolic block factorization
(block fill mask), the batched blocked numerical Cholesky, and the packed
block layout (the fill mask as storage) with its Cholesky and triangular
solves."""
from repro_torch.sparse.cholesky import block_cholesky, block_cholesky_flops
from repro_torch.sparse.ordering import (
    nested_dissection_order,
    node_ordering,
    rcm_order,
)
from repro_torch.sparse.packed import (
    PackedBlockIndex,
    PackedBlocks,
    block_cholesky_packed,
    pack_factor,
    packed_block_index_for,
    packed_symm_matvec,
    packed_tri_solve,
)
from repro_torch.sparse.symbolic import (
    block_pattern,
    block_symbolic_cholesky,
    matrix_pattern_from_elems,
)

__all__ = [
    "PackedBlockIndex",
    "PackedBlocks",
    "block_cholesky",
    "block_cholesky_flops",
    "block_cholesky_packed",
    "block_pattern",
    "block_symbolic_cholesky",
    "matrix_pattern_from_elems",
    "nested_dissection_order",
    "node_ordering",
    "pack_factor",
    "packed_block_index_for",
    "packed_symm_matvec",
    "packed_tri_solve",
    "rcm_order",
]
