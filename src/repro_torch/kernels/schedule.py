"""Work order of the fused TRSM→SYRK kernels (``csrc/stepped_trsm_syrk.cu``).

The fused kernels' blocks draw items from one list through an atomic
ticket. The list depends only on the shapes, the stripes' start blocks and,
for a packed factor, its CSR block index, so it is built here on the host
once per plan and cached, and uploaded once per plan and device
(:func:`fused_work_order_on`, which ``kernels/ops.py`` calls beside the
start blocks and hands to the wrapper):

* every TRSM item — one 32-column tile of one subdomain (``col_tiles =
  ceil(m / 32)``; the last tile is clipped at m), code
  ``s * col_tiles + tile`` — in non-increasing cost (a stable sort, so
  the tiles of one subdomain stay neighbours);
* then every SYRK item — one 64 × 64 sub-tile (clipped) of one lower
  group of stripes of one subdomain, code ``S * col_tiles + (s *
  lower_groups + group) * subs² + sub`` — those that reduce over the most
  rows first (a stable sort).

A group (:func:`fused_groups`) is ``G = 64 // bm`` stripes when bm < 64,
else one stripe; it is ``G · bm`` columns wide and cut into ``subs²``
sub-tiles of 64 × 64 (``subs`` is 1 unless bm > 64). Only lower groups
``(gi, gj <= gi)`` get items, numbered ``gi (gi + 1) / 2 + gj``; the last
group is clipped at m. An item's region starts at row ``gi · G · bm +
(sub // subs) · 64`` and column ``gj · G · bm + (sub % subs) · 64`` and
is clipped at the group's end and at m. At bm >= 64 an item is a 64 × 64
sub-tile of one ``bm × bm`` tile.

Costs count 128×128×32-shaped tile products. A dense TRSM item of a stripe
starting at block ``st`` costs ``Σ_{k=st}^{nb-1} (k - st + 1)``: row k
multiplies ``k - st`` factor tiles and its diagonal block. A packed one
costs the stored slots it walks: in rows ``k >= st``, the slots with block
column ``>= st``, the diagonal included.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels._launch import FUSED_SYRK_TILE, TILE

__all__ = ["trsm_stripe_costs", "fused_groups", "fused_item_count",
           "fused_work_order", "fused_work_order_on"]


def fused_groups(m: int, bm: int) -> tuple[int, int, int]:
    """``(G, groups, subs)`` of the fused kernels' SYRK items for m
    columns in bm-wide stripes: stripes a group, groups, 64 × 64
    sub-tiles a side of a group."""
    g = FUSED_SYRK_TILE // bm if bm < FUSED_SYRK_TILE else 1
    return g, -(-(m // bm) // g), -(-(g * bm) // FUSED_SYRK_TILE)


def fused_item_count(S: int, m: int, bm: int) -> int:
    """Items of a fused launch: every TRSM item, then every SYRK item."""
    _, groups, subs = fused_groups(m, bm)
    return S * -(-m // TILE) + S * groups * (groups + 1) // 2 * subs * subs


def trsm_stripe_costs(starts, nb: int, rowptr=None, colidx=None) -> np.ndarray:
    """Tile products one TRSM item of each stripe costs; dense without a
    CSR index, packed with one."""
    costs = []
    for st in (int(x) for x in starts):
        if rowptr is None:
            rows = nb - min(st, nb)
            costs.append(rows * (rows + 1) // 2)
        else:
            costs.append(sum(int(np.count_nonzero(
                np.asarray(colidx[rowptr[k]:rowptr[k + 1]]) >= st))
                for k in range(st, nb)))
    return np.asarray(costs, dtype=np.int64)


@functools.lru_cache(maxsize=32)
def _order(starts: tuple, S: int, nb: int, m: int, bm: int,
           rowptr: tuple | None, colidx: tuple | None) -> np.ndarray:
    col_tiles = -(-m // TILE)
    g, groups, subs = fused_groups(m, bm)
    stripe_cost = trsm_stripe_costs(starts, nb, rowptr, colidx)
    tile_stripe = np.arange(col_tiles) * TILE // bm
    trsm_cost = np.tile(stripe_cost[tile_stripe], S)  # code s*col_tiles + t
    trsm = np.argsort(-trsm_cost, kind="stable")
    # SYRK: lower group (gi, gj <= gi) reduces over nb - starts[gi * G] row
    # blocks, from its first row stripe's start
    rows = np.asarray([nb - min(int(starts[gi * g]), nb)
                       for gi in range(groups) for _ in range(gi + 1)])
    syrk_rows = np.tile(np.repeat(rows, subs * subs), S)
    syrk = np.argsort(-syrk_rows, kind="stable") + S * col_tiles
    order = np.concatenate([trsm, syrk]).astype(np.int32)
    order.setflags(write=False)
    return order


@functools.lru_cache(maxsize=32)
def _order_on(key: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_order(*key).copy()).to(device)


def _key(starts, S, nb, m, bm, rowptr, colidx) -> tuple:
    return (tuple(int(x) for x in starts), int(S), int(nb), int(m), int(bm),
            None if rowptr is None else tuple(int(x) for x in rowptr),
            None if colidx is None else tuple(int(x) for x in colidx))


def fused_work_order(starts, S: int, nb: int, m: int, bm: int,
                     rowptr=None, colidx=None) -> np.ndarray:
    """The fused kernels' item list (int32 codes, read-only, cached per
    plan). ``starts`` is the host array of the (m // bm,) start block of
    each stripe; pass the packed factor's host ``rowptr`` and ``colidx``
    for the packed kernel."""
    return _order(*_key(starts, S, nb, m, bm, rowptr, colidx))


def fused_work_order_on(device, starts, S: int, nb: int, m: int, bm: int,
                        rowptr=None, colidx=None) -> torch.Tensor:
    """:func:`fused_work_order` as an int32 tensor on ``device``, cached
    per plan and device: built from host values only, so it never reads
    the device back. Callers must not write to it."""
    return _order_on(_key(starts, S, nb, m, bm, rowptr, colidx),
                     torch.device(device))

