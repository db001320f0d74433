"""Sparse substrate: fill-reducing orderings, symbolic block factorization
(block fill mask), the batched blocked numerical Cholesky, and the packed
block layout of the lumped preconditioner's stiffness."""
from repro_torch.sparse.cholesky import block_cholesky
from repro_torch.sparse.ordering import (
    nested_dissection_order,
    node_ordering,
    rcm_order,
)
from repro_torch.sparse.packed import (
    PackedBlockIndex,
    PackedBlocks,
    packed_symm_matvec,
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
    "block_pattern",
    "block_symbolic_cholesky",
    "matrix_pattern_from_elems",
    "nested_dissection_order",
    "node_ordering",
    "packed_symm_matvec",
    "rcm_order",
]
