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
from repro_torch.kernels.stepped_syrk import stepped_syrk_plain  # noqa: E402
from repro_torch.kernels._launch import FUSED_SYRK_TILE, TILE  # noqa: E402
from repro_torch.kernels.schedule import (  # noqa: E402
    fused_groups,
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


# feti-heat-2d re-blocked at bs = bm = 16: n_pad 4352 (nb 272), m_pad 272,
# 17 stripes in groups of 4, the last group one stripe
HEAT2D_BS16 = [16 * i for i in range(17)]

CASES = [
    # starts, S, nb, m, bm, packed
    ([0, 16, 32], 64, 34, 384, 128, False),  # the full-size plan
    ([0, 16, 32], 3, 34, 384, 128, True),
    ([0, 2, 2, 5], 4, 6, 128, 32, False),  # bm 32: 2 stripes a group
    ([1, 3, 6], 5, 6, 288, 96, True),  # a ragged sub-tile; the last stripe empty
    ([0], 1, 1, 32, 32, False),
    (HEAT2D_BS16, 64, 272, 272, 16, False),  # m no multiple of 32
    (HEAT2D_BS16, 2, 272, 272, 16, True),
    # bm 24: groups of 2 stripes, 48 wide, off the 32-column tiles
    ([0, 1, 1, 3, 4, 6, 8], 3, 9, 168, 24, True),
    ([0, 2, 3, 3, 5], 2, 6, 200, 40, False),  # bm 40: a group is one stripe
    # bm 8, m 264: 33 stripes in groups of 8, the last group one stripe, the
    # last TRSM tile clipped at m
    ([k // 4 for k in range(33)], 2, 10, 264, 8, False),
]
TILE_CASES = [c for c in CASES if c[4] >= FUSED_SYRK_TILE]


def _group_stripes(bm):
    """Stripes a SYRK group takes: as many as fit 64 columns, at least one."""
    return max(FUSED_SYRK_TILE // bm, 1)


def decode_item(code, S, m, bm):
    """``("trsm", s, column tile)`` or ``("syrk", s, gi, gj, sub)``: an
    item code decoded as csrc/stepped_trsm_syrk.cu decodes it."""
    col_tiles = -(-m // TILE)
    if code < S * col_tiles:
        return ("trsm", code // col_tiles, code % col_tiles)
    g = _group_stripes(bm)
    groups = -(-(m // bm) // g)
    per_group = (-(-(g * bm) // FUSED_SYRK_TILE)) ** 2
    s, rem = divmod(code - S * col_tiles,
                    groups * (groups + 1) // 2 * per_group)
    group, sub = divmod(rem, per_group)
    gi = 0
    while (gi + 1) * (gi + 2) // 2 <= group:
        gi += 1
    return ("syrk", s, gi, group - gi * (gi + 1) // 2, sub)


def region(item, m, bm):
    """``(r0, r1, c0, c1)``: the rows and columns of F a decoded SYRK item
    covers, clipped as the kernel clips them."""
    _, _, gi, gj, sub = item
    width = _group_stripes(bm) * bm
    subs = -(-width // FUSED_SYRK_TILE)
    r0 = gi * width + (sub // subs) * FUSED_SYRK_TILE
    c0 = gj * width + (sub % subs) * FUSED_SYRK_TILE
    return (r0, min(r0 + FUSED_SYRK_TILE, (gi + 1) * width, m),
            c0, min(c0 + FUSED_SYRK_TILE, (gj + 1) * width, m))


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
    col_tiles = -(-m // TILE)
    g = _group_stripes(bm)
    groups = -(-(m // bm) // g)
    subs = -(-(g * bm) // FUSED_SYRK_TILE)
    n_syrk = S * groups * (groups + 1) // 2 * subs * subs
    assert order.dtype == np.int32
    # the count the wrapper checks the list against; the launcher refuses
    # any length but its own count of every item
    assert order.size == fused_item_count(S, m, bm)
    np.testing.assert_array_equal(np.sort(order),
                                  np.arange(S * col_tiles + n_syrk))
    trsm = {it[1:] for it in items if it[0] == "trsm"}
    assert trsm == {(s, t) for s in range(S) for t in range(col_tiles)}
    syrk = {it[1:] for it in items if it[0] == "syrk"}
    assert syrk == {(s, i, j, q) for s in range(S) for i in range(groups)
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
    # SYRK items: the most rows to reduce first, from the start of the
    # group's first row stripe
    g = _group_stripes(bm)
    rows = [nb - min(starts[it[2] * g], nb) for it in items[n_trsm:]]
    assert all(a >= b for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("starts,S,nb,m,bm,packed", CASES)
def test_syrk_items_wait_only_on_earlier_trsm_items(starts, S, nb, m, bm,
                                                    packed):
    """Every column tile a SYRK item reads (its rows and its columns of Y)
    is a TRSM item placed before it in the list, and every item's region
    is a non-empty part of its own group."""
    _, items, _, _ = _items(starts, S, nb, m, bm, packed)
    width = _group_stripes(bm) * bm
    seen = set()
    for it in items:
        if it[0] == "trsm":
            seen.add(it[1:])
            continue
        s, gi, gj = it[1:4]
        r0, r1, c0, c1 = region(it, m, bm)
        assert gi * width <= r0 < r1 <= min((gi + 1) * width, m)
        assert gj * width <= c0 < c1 <= min((gj + 1) * width, m)
        needed = {(s, c // TILE) for c in [*range(r0, r1), *range(c0, c1)]}
        assert needed <= seen


@pytest.mark.parametrize("starts,S,nb,m,bm,packed", CASES)
def test_syrk_items_store_the_plain_result_once(starts, S, nb, m, bm,
                                                packed):
    """The SYRK items emulated in numpy by syrk_tile's rule, on a random
    Y (no zeros above the starts, so the row mask must do the work): each
    region reduces from its first row stripe's start, every staged row
    element above its own column's start is zero, and only entries whose
    column stripe is at or before the row stripe are stored. Their union
    is the plain stepped SYRK; every lower-block entry is written exactly
    once and no upper one."""
    bs, S = 8, min(S, 2)
    n = nb * bs
    _, items, _, _ = _items(starts, S, nb, m, bm, packed)
    Y = np.random.default_rng(m + bm).standard_normal((S, n, m))
    start = np.repeat(np.minimum(np.asarray(starts), nb) * bs, bm)  # by column
    stripe = np.arange(m) // bm
    F = np.zeros((S, m, m))
    writes = np.zeros((S, m, m), dtype=int)
    for it in items:
        if it[0] == "trsm":
            continue
        s = it[1]
        r0, r1, c0, c1 = region(it, m, bm)
        k0 = start[r0]
        A = Y[s, k0:, r0:r1] * (np.arange(k0, n)[:, None] >= start[r0:r1])
        stored = stripe[c0:c1][None, :] <= stripe[r0:r1][:, None]
        F[s, r0:r1, c0:c1][stored] = (A.T @ Y[s, k0:, c0:c1])[stored]
        writes[s, r0:r1, c0:c1] += stored
    lower = stripe[None, :] <= stripe[:, None]
    np.testing.assert_array_equal(writes, np.broadcast_to(lower, F.shape))
    want = stepped_syrk_plain(torch.from_numpy(Y),
                              torch.as_tensor(starts), bs, bm).numpy()
    np.testing.assert_allclose(F, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _tile_regions(codes, S, m, bm):
    """The regions of SYRK codes in the list before groups: one item a
    64 × 64 sub-tile of one lower ``bm × bm`` tile."""
    col_tiles, nc = -(-m // TILE), m // bm
    subs = -(-bm // FUSED_SYRK_TILE)
    out = []
    for code in codes:
        _, rem = divmod(code - S * col_tiles, nc * (nc + 1) // 2 * subs * subs)
        tile, sub = divmod(rem, subs * subs)
        ti = 0
        while (ti + 1) * (ti + 2) // 2 <= tile:
            ti += 1
        tj = tile - ti * (ti + 1) // 2
        r0 = ti * bm + (sub // subs) * FUSED_SYRK_TILE
        c0 = tj * bm + (sub % subs) * FUSED_SYRK_TILE
        out.append((r0, min(r0 + FUSED_SYRK_TILE, (ti + 1) * bm),
                    c0, min(c0 + FUSED_SYRK_TILE, (tj + 1) * bm)))
    return out


@pytest.mark.parametrize("starts,S,nb,m,bm,packed", TILE_CASES)
def test_wide_stripes_keep_the_list_before_groups(starts, S, nb, m, bm,
                                                  packed):
    """bm >= 64: a group is one stripe, so the list's length, its order and
    every item's region are those of one item a sub-tile of a bm × bm
    tile."""
    order, items, _, _ = _items(starts, S, nb, m, bm, packed)
    nc, subs = m // bm, -(-bm // FUSED_SYRK_TILE)
    n_trsm = S * -(-m // TILE)
    assert order.size == n_trsm + S * nc * (nc + 1) // 2 * subs * subs
    assert [region(it, m, bm) for it in items[n_trsm:]] == _tile_regions(
        [int(c) for c in order[n_trsm:]], S, m, bm)


def test_item_counts_of_the_planned_small_blocks():
    """feti-heat-2d at bs = bm = 16 (S 64, m 272): 576 TRSM items and 960
    SYRK items (15 lower groups of 4 stripes; one item a 16 × 16 tile would
    be 9,792); feti-elasticity-3d at bs = bm = 8 (S 8, m 896): 224 and 840
    (105 lower groups of 8 stripes, against 50,624)."""
    assert fused_item_count(64, 272, 16) == 576 + 960
    assert fused_item_count(8, 896, 8) == 224 + 840
    assert fused_groups(272, 16) == (4, 5, 1)
    assert fused_groups(288, 24) == (2, 6, 1)
    for bm in (40, 48, 56, 64):
        assert fused_groups(7 * bm, bm) == (1, 7, 1)
    assert fused_groups(384, 128) == (1, 3, 2)


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

