"""Structured simplicial meshes: unit square into triangles, unit cube into
tetrahedra (paper §4: "square or cube domain uniformly discretized into
triangles or tetrahedra").

Numpy-only copy of ``repro.fem.meshgen``. Topology is host-side numpy (it
is the symbolic part of the pipeline and is fixed across the multi-step
simulation); values flow through torch downstream.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Mesh", "structured_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A simplicial mesh: P1 nodes + element connectivity."""

    dim: int
    coords: np.ndarray  # (n_nodes, dim) float64
    elems: np.ndarray  # (n_elems, dim+1) int64

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elems.shape[0]


def _grid_coords(shape: tuple[int, ...], origin, spacing) -> np.ndarray:
    axes = [origin[d] + spacing[d] * np.arange(shape[d] + 1) for d in range(len(shape))]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel(order="F") for g in grids], axis=1)


def _node_id(shape: tuple[int, ...], *idx) -> np.ndarray:
    """Fortran-order node id on an (n0+1, n1+1, ...) node grid."""
    strides = [1]
    for d in range(len(shape) - 1):
        strides.append(strides[-1] * (shape[d] + 1))
    return sum(np.asarray(idx[d]) * strides[d] for d in range(len(shape)))


def structured_mesh(
    shape: tuple[int, ...],
    origin: tuple[float, ...] | None = None,
    lengths: tuple[float, ...] | None = None,
) -> Mesh:
    """Uniform simplicial mesh of a box.

    2D: each of the ``nx*ny`` squares is split into 2 triangles.
    3D: each of the ``nx*ny*nz`` cubes is split into 6 tetrahedra (Kuhn).
    """
    dim = len(shape)
    if dim not in (2, 3):
        raise ValueError("only 2D/3D structured meshes are supported")
    origin = origin or (0.0,) * dim
    lengths = lengths or (1.0,) * dim
    spacing = tuple(lengths[d] / shape[d] for d in range(dim))
    coords = _grid_coords(shape, origin, spacing)

    if dim == 2:
        nx, ny = shape
        ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        ix, iy = ix.ravel(), iy.ravel()
        v00 = _node_id(shape, ix, iy)
        v10 = _node_id(shape, ix + 1, iy)
        v01 = _node_id(shape, ix, iy + 1)
        v11 = _node_id(shape, ix + 1, iy + 1)
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        elems = np.concatenate([t1, t2], axis=0)
    else:
        nx, ny, nz = shape
        ix, iy, iz = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()

        def corner(dx, dy, dz):
            return _node_id(shape, ix + dx, iy + dy, iz + dz)

        # Kuhn / staircase decomposition: for each of the 6 axis orders,
        # tet = [c000, c000+e_a, c000+e_a+e_b, c111].
        import itertools

        e = {0: (1, 0, 0), 1: (0, 1, 0), 2: (0, 0, 1)}
        tets = []
        for a, b, c in itertools.permutations((0, 1, 2)):
            p0 = corner(0, 0, 0)
            s1 = e[a]
            p1 = corner(*s1)
            s2 = tuple(s1[d] + e[b][d] for d in range(3))
            p2 = corner(*s2)
            p3 = corner(1, 1, 1)
            tets.append(np.stack([p0, p1, p2, p3], axis=1))
        elems = np.concatenate(tets, axis=0)

    return Mesh(dim=dim, coords=coords, elems=elems.astype(np.int64))
