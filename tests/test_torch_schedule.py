"""The fused kernels' work order (``repro_torch.kernels.schedule``).

The fused TRSM→SYRK kernels draw items from this list through one atomic
ticket, and a SYRK item waits for the TRSM items of the stripes it reads.
Their freedom from deadlock rests on the list's shape, checked here on the
CPU: a permutation of every item, TRSM items first in non-increasing cost,
every SYRK item's stripes among the TRSM items. The packed costs are held
against the slots the packed walk visits, counted from the block mask. The
list is built in ``kernels/ops.py`` from host values, cached per plan and
device, and handed to the fused wrappers as an operand.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build_stepped_meta  # noqa: E402
from repro_torch.kernels import ops, stepped_trsm_syrk  # noqa: E402
from repro_torch.kernels._launch import FUSED_SYRK_TILE, TILE  # noqa: E402
from repro_torch.kernels.schedule import (  # noqa: E402
    fused_item_count,
    fused_work_order,
    fused_work_order_on,
    trsm_stripe_costs,
)
from repro_torch.sparse import PackedBlockIndex, pack_factor  # noqa: E402

pytestmark = pytest.mark.torch_port


def _packed_index(nb, bs, seed):
    rng = np.random.default_rng(seed)
    mask = np.tril(rng.random((nb, nb)) < 0.35)
    np.fill_diagonal(mask, True)
    return PackedBlockIndex.from_mask(mask, nb * bs, bs), mask


CASES = [
    # starts, S, nb, m, bm, packed
    ([0, 16, 32], 64, 34, 384, 128, False),  # the full-size plan
    ([0, 16, 32], 3, 34, 384, 128, True),
    ([0, 2, 2, 5], 4, 6, 128, 32, False),  # bm < the SYRK sub-tile
    ([1, 3, 6], 5, 6, 288, 96, True),  # a ragged sub-tile; the last stripe empty
    ([0], 1, 1, 32, 32, False),
]


def decode_item(code, S, m, bm):
    """``("trsm", s, column tile)`` or ``("syrk", s, ti, tj, sub)``: an
    item code decoded as csrc/stepped_trsm_syrk.cu decodes it."""
    col_tiles = m // TILE
    if code < S * col_tiles:
        return ("trsm", code // col_tiles, code % col_tiles)
    subs = -(-bm // FUSED_SYRK_TILE)
    per_tile = subs * subs
    nc = m // bm
    s, rem = divmod(code - S * col_tiles, nc * (nc + 1) // 2 * per_tile)
    tile, sub = divmod(rem, per_tile)
    ti = 0
    while (ti + 1) * (ti + 2) // 2 <= tile:
        ti += 1
    return ("syrk", s, ti, tile - ti * (ti + 1) // 2, sub)


def _items(starts, S, nb, m, bm, packed, seed=0):
    rp = ci = None
    if packed:
        index, _ = _packed_index(nb, 16, seed)
        rp, ci = index.rowptr, index.cols
    order = fused_work_order(np.asarray(starts), S, nb, m, bm, rp, ci)
    return order, [decode_item(int(c), S, m, bm) for c in order], rp, ci


@pytest.mark.parametrize("starts,S,nb,m,bm,packed", CASES)
def test_order_is_a_permutation_of_every_item(starts, S, nb, m, bm, packed):
    order, items, _, _ = _items(starts, S, nb, m, bm, packed)
    nc, col_tiles = m // bm, m // TILE
    subs = -(-bm // FUSED_SYRK_TILE)
    n_syrk = S * nc * (nc + 1) // 2 * subs * subs
    assert order.dtype == np.int32
    # the count the wrapper checks the list against; the launcher refuses
    # any length but its own count of every item
    assert order.size == fused_item_count(S, m, bm)
    np.testing.assert_array_equal(np.sort(order),
                                  np.arange(S * col_tiles + n_syrk))
    trsm = {it[1:] for it in items if it[0] == "trsm"}
    assert trsm == {(s, t) for s in range(S) for t in range(col_tiles)}
    syrk = {it[1:] for it in items if it[0] == "syrk"}
    assert syrk == {(s, i, j, q) for s in range(S) for i in range(nc)
                    for j in range(i + 1) for q in range(subs * subs)}


@pytest.mark.parametrize("starts,S,nb,m,bm,packed", CASES)
def test_trsm_items_first_in_non_increasing_cost(starts, S, nb, m, bm,
                                                 packed):
    _, items, rp, ci = _items(starts, S, nb, m, bm, packed)
    kinds = [it[0] for it in items]
    n_trsm = kinds.count("trsm")
    assert kinds == ["trsm"] * n_trsm + ["syrk"] * (len(kinds) - n_trsm)
    cost = trsm_stripe_costs(starts, nb, rp, ci)
    trsm_cost = [cost[t * TILE // bm] for _, _, t in items[:n_trsm]]
    assert all(a >= b for a, b in zip(trsm_cost, trsm_cost[1:]))
    # SYRK items: the most rows to reduce first
    rows = [nb - min(starts[it[2]], nb) for it in items[n_trsm:]]
    assert all(a >= b for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("starts,S,nb,m,bm,packed", CASES)
def test_syrk_items_wait_only_on_earlier_trsm_items(starts, S, nb, m, bm,
                                                    packed):
    """Every column tile a SYRK sub-tile reads (its rows and its columns of
    Y) is a TRSM item placed before it in the list."""
    _, items, _, _ = _items(starts, S, nb, m, bm, packed)
    subs = -(-bm // FUSED_SYRK_TILE)
    seen = set()
    for it in items:
        if it[0] == "trsm":
            seen.add(it[1:])
            continue
        s, ti, tj, q = it[1:]
        r0 = ti * bm + (q // subs) * FUSED_SYRK_TILE
        c0 = tj * bm + (q % subs) * FUSED_SYRK_TILE
        r1 = min(r0 + FUSED_SYRK_TILE, (ti + 1) * bm)
        c1 = min(c0 + FUSED_SYRK_TILE, (tj + 1) * bm)
        assert r0 < r1 and c0 < c1  # no empty sub-tile
        needed = {(s, c // TILE) for c in [*range(r0, r1), *range(c0, c1)]}
        assert needed <= seen
        # and they are the stripes' own tiles
        assert {c * TILE // bm for _, c in needed} <= {ti, tj}


def test_full_size_dense_costs():
    np.testing.assert_array_equal(trsm_stripe_costs([0, 16, 32], 34),
                                  [595, 171, 3])
    order, items, _, _ = _items([0, 16, 32], 64, 34, 384, 128, False)
    # 256 start-0 items lead, then 256 start-16, then 256 start-32
    stripes = [t * TILE // 128 for _, _, t in items[:768]]
    assert stripes == [0] * 256 + [1] * 256 + [2] * 256
    assert trsm_stripe_costs([34], 34)[0] == 0  # an empty stripe


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_costs_are_the_walked_slots(seed):
    """The packed TRSM of a stripe starting at block st walks, in each row
    k >= st, the stored blocks (k, j) with st <= j < k, then applies the
    diagonal: counted here from the block mask."""
    nb = 12
    index, mask = _packed_index(nb, 16, seed)
    starts = [0, 3, 7, 11, 12]
    want = [sum(int(mask[k, j]) for k in range(st, nb)
                for j in range(st, k + 1)) for st in starts]
    np.testing.assert_array_equal(
        trsm_stripe_costs(starts, nb, index.rowptr, index.cols), want)
    # on a full mask the packed cost is the dense one
    full = PackedBlockIndex.from_mask(np.tril(np.ones((nb, nb), bool)),
                                      nb * 16, 16)
    np.testing.assert_array_equal(
        trsm_stripe_costs(starts, nb, full.rowptr, full.cols),
        trsm_stripe_costs(starts, nb))


def test_order_is_cached_per_plan():
    a = fused_work_order(np.array([0, 1]), 2, 4, 64, 32)
    assert fused_work_order([0, 1], 2, 4, 64, 32) is a
    assert not a.flags.writeable
    assert fused_work_order([0, 2], 2, 4, 64, 32) is not a


def test_order_on_device_is_cached_per_plan_and_device():
    t = fused_work_order_on("cpu", np.array([0, 1]), 2, 4, 64, 32)
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(),
                                  fused_work_order([0, 1], 2, 4, 64, 32))
    assert fused_work_order_on(torch.device("cpu"), [0, 1], 2, 4, 64, 32) is t
    assert fused_work_order_on("cpu", [0, 2], 2, 4, 64, 32) is not t


def _small_plan(seed=0):
    rng = np.random.default_rng(seed)
    n, m, bs, bm, S = 40, 24, 8, 8, 2
    nb = n // bs
    mask = np.tril(rng.random((nb, nb)) < 0.5)
    np.fill_diagonal(mask, True)
    L = np.zeros((S, n, n))
    for i, j in zip(*np.nonzero(mask)):
        blk = rng.standard_normal((S, bs, bs)) * 0.1
        if i == j:
            blk = np.tril(blk) + 2 * np.eye(bs)
        L[:, i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = blk
    Bt = np.zeros((n, m))
    Bt[rng.integers(0, n, size=m), np.arange(m)] = 1.0
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    B = torch.from_numpy(np.broadcast_to(Bt[:, meta.perm], (S, n, m)).copy())
    Lt = torch.from_numpy(L)
    return Lt, pack_factor(Lt, PackedBlockIndex.from_mask(mask, n, bs)), B, meta


@pytest.mark.parametrize("packed", [False, True])
def test_ops_hands_the_cached_order_to_the_fused_wrapper(packed, monkeypatch):
    """ops.stepped_trsm_syrk builds the list from the host start blocks
    (and the packed index) and passes the cached tensor; the wrapper never
    builds it."""
    L, pb, B, meta = _small_plan()
    name = ("stepped_trsm_syrk_packed_kernel" if packed
            else "stepped_trsm_syrk_kernel")
    wrapper = getattr(ops, name)
    seen = []

    def spy(*args, order=None, **kwargs):
        seen.append(order)
        return wrapper(*args, order=order, **kwargs)

    monkeypatch.setattr(ops, name, spy)
    F = ops.stepped_trsm_syrk(pb if packed else L, B, meta)
    index = pb.index if packed else None
    want = ops._fused_order(meta, 2, B.device, index)
    assert len(seen) == 1 and seen[0] is want
    bs, bm, n_pad, m_pad = ops._padded_sizes(meta)
    csr = (index.rowptr, index.cols) if packed else ()
    np.testing.assert_array_equal(
        want.numpy(), fused_work_order(
            ops._start_blocks(meta, bm, bs, m_pad, n_pad), 2, n_pad // bs,
            m_pad, bm, *csr))
    assert F.shape == (2, meta.m, meta.m)


@pytest.mark.parametrize("bad", ["none", "short", "int64"])
def test_fused_wrapper_checks_its_item_list(bad):
    """What a CUDA launch would refuse, checked on host tensors."""
    B = torch.zeros(2, 64, 96, dtype=torch.float64)
    order = fused_work_order_on("cpu", [0, 1, 1], 2, 2, 96, 32)
    stepped_trsm_syrk._check_order(order, B, 32)  # the right list passes
    wrong = {"none": None, "short": order[1:], "int64": order.long()}[bad]
    with pytest.raises(ValueError, match="item list|order must be"):
        stepped_trsm_syrk._check_order(wrong, B, 32)

