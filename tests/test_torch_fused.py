"""The port's fused TRSM→SYRK (dense and packed factor) against the
reference, and the new kernels against their plain versions on the card.

On the CPU the wrappers run their plain versions. The reference's fused
Pallas kernels cannot run on the installed jax (ROADMAP C1), so the fused
result is held against the reference's UNFUSED Pallas pair in interpret
mode — stepped TRSM (or packed stepped TRSM) then stepped SYRK — which
computes the same F; tolerance 1e-12 relative to its scale. The ``cuda``
cases hold the packed TRSM (B3) and both fused kernels (B4, B5) against
their plain versions and their unfused or dense twins on the card, and
the f32 fused kernels against their f32 plain versions and the f64
kernels on the same f32 operands; they need no JAX, so the card's machine
runs them with
``python -m pytest --noconftest -m cuda tests/test_torch_fused.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    SchurAssemblyConfig,
    assemble_schur,
    assembly_flops,
    build_stepped_meta,
    schur_dense_baseline,
)
from repro_torch.kernels import (  # noqa: E402
    ops,
    stepped_syrk_kernel,
    stepped_trsm_kernel,
    stepped_trsm_packed_kernel,
    stepped_trsm_packed_plain,
    stepped_trsm_syrk_kernel,
    stepped_trsm_syrk_packed_kernel,
    stepped_trsm_syrk_packed_plain,
    stepped_trsm_syrk_plain,
)
from repro_torch.launch import solve_feti  # noqa: E402
from repro_torch.sparse import PackedBlockIndex, pack_factor  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-12


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _masked_factor(n, bs, S, rng):
    """(S, n, n) nonsingular lower factors that are zero outside a random
    block mask (about 40% of the strictly-lower blocks present), and the
    mask."""
    nb = -(-n // bs)
    mask = np.tril(rng.random((nb, nb)) < 0.4)
    np.fill_diagonal(mask, True)
    L = np.zeros((S, n, n))
    scale = 0.5 / np.sqrt(bs * nb)
    for i, j in zip(*np.nonzero(mask)):
        r0, r1 = i * bs, min((i + 1) * bs, n)
        c0, c1 = j * bs, min((j + 1) * bs, n)
        blk = rng.standard_normal((S, r1 - r0, c1 - c0)) * scale
        if i == j:
            blk = np.tril(blk) + np.eye(r1 - r0) * (1.0 + rng.random(r1 - r0))
        L[:, r0:r1, c0:c1] = blk
    return L, mask


def _stepped_rhs(n, m, rng, empty=0):
    """B̃ᵀ-like (n, m): ±1 near a random anchor row per column, the last
    ``empty`` columns zero."""
    Bt = np.zeros((n, m))
    for j in range(m - empty):
        a = int(rng.integers(0, n))
        for r in np.unique(np.clip(a + rng.integers(0, 5, size=2), 0, n - 1)):
            Bt[r, j] = rng.choice([-1.0, 1.0])
    return Bt


def _case(n, m, bs, bm, S, empty, seed, device="cpu"):
    """(dense L, packed L, stepped B, meta) on ``device``."""
    rng = np.random.default_rng(seed)
    L, mask = _masked_factor(n, bs, S, rng)
    Bt = _stepped_rhs(n, m, rng, empty)
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    B = np.broadcast_to(Bt[:, meta.perm], (S, n, m)).copy()
    Lt = torch.from_numpy(L).to(device)
    packed = pack_factor(Lt, PackedBlockIndex.from_mask(mask, n, bs))
    assert packed.index.n_blocks < packed.index.nb * (packed.index.nb + 1) // 2
    return Lt, packed, torch.from_numpy(B).to(device), meta


CPU_CASES = [
    # n, m, bs, bm, S, empty columns
    (61, 30, 8, 8, 2, 0),  # ragged n: 61 -> 64, m 30 -> 32
    (64, 40, 16, 8, 2, 8),  # the last stripe is all padding: start = nb
    # bs 256, the reference planner's largest: n 600 -> 768, three block
    # rows, two of the three lower blocks stored
    (600, 100, 256, 32, 2, 0),
]


@pytest.mark.parametrize("storage", ["dense", "packed"])
@pytest.mark.parametrize("n,m,bs,bm,S,empty", CPU_CASES)
def test_plain_fused_matches_reference_unfused(n, m, bs, bm, S, empty,
                                               storage):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import build_stepped_meta as ref_meta
    from repro.kernels import ops as ref_ops
    from repro.sparse import packed as ref_packed

    L, pb, B, meta = _case(n, m, bs, bm, S, empty, seed=n + m)
    fac = pb if storage == "packed" else L
    launches = (stepped_trsm_syrk_kernel.launches,
                stepped_trsm_syrk_packed_kernel.launches)
    got = ops.stepped_trsm_syrk(fac, B, meta)
    assert (stepped_trsm_syrk_kernel.launches,
            stepped_trsm_syrk_packed_kernel.launches) == launches  # CPU: plain
    # the unfused twin, through the port's stepped TRSM and SYRK
    trsm = ops.stepped_trsm_packed if storage == "packed" else ops.stepped_trsm
    np.testing.assert_array_equal(
        got.numpy(), ops.stepped_syrk(trsm(fac, B, meta), meta).numpy())
    rmeta = ref_meta(B[0].numpy() != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    ref_index = ref_packed.PackedBlockIndex.from_mask(pb.index.mask, n, bs)
    for s in range(S):
        if storage == "packed":
            Y = ref_ops.stepped_trsm_packed(
                ref_packed.PackedBlocks(jnp.asarray(pb.values[s].numpy()),
                                        ref_index),
                jnp.asarray(B[s].numpy()), rmeta, interpret=True)
        else:
            Y = ref_ops.stepped_trsm(jnp.asarray(L[s].numpy()),
                                     jnp.asarray(B[s].numpy()), rmeta,
                                     interpret=True)
        _close(got[s].numpy(), ref_ops.stepped_syrk(Y, rmeta, interpret=True))
    _close(got.numpy(), schur_dense_baseline(L, B).numpy())


def test_fused_upper_tiles_are_zero():
    L, pb, B, meta = _case(61, 30, 8, 8, 2, 0, seed=1)
    bs, bm, n_pad, m_pad = ops._padded_sizes(meta)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts = ops._starts(meta, B.device)
    Lp = ops.pad_factor(L, n_pad)
    for Fl in (stepped_trsm_syrk_kernel(ops.invert_diag_blocks(Lp, bs), Lp, Bp,
                                        starts, bs, bm),
               stepped_trsm_syrk_packed_kernel(*ops._packed_operands(pb, meta),
                                               Bp, starts, bs, bm)):
        for i in range(m_pad // bm):
            assert torch.all(Fl[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)
            assert torch.any(Fl[:, i * bm:(i + 1) * bm, :(i + 1) * bm] != 0)


def test_fused_config():
    pytest.importorskip("jax")
    from repro.core import SchurAssemblyConfig as RefConfig
    from repro.core import assembly_flops as ref_assembly_flops
    from repro.core import build_stepped_meta as ref_meta

    with pytest.raises(ValueError, match="use_kernels"):
        SchurAssemblyConfig(fused=True)
    cfg = SchurAssemblyConfig(trsm_variant="dense", syrk_variant="dense",
                              block_size=8, use_kernels=True, fused=True)
    assert not cfg.is_dense_baseline
    L, pb, B, _ = _case(61, 30, 8, 8, 2, 0, seed=2)
    # B's columns are already stepped: the metadata's permutation is the
    # identity, so assemble_schur's own permutation keeps them in place
    meta = build_stepped_meta(B[0].numpy() != 0, block_size=8, rhs_block_size=8)
    rmeta = ref_meta(B[0].numpy() != 0, block_size=8, rhs_block_size=8)
    ref_cfg = RefConfig(trsm_variant="dense", syrk_variant="dense",
                        block_size=8, use_pallas=True, fused=True,
                        storage="dense")
    assert assembly_flops(meta, cfg) == ref_assembly_flops(rmeta, ref_cfg)
    # the fused assembly in the original column order, both storages
    base = schur_dense_baseline(L, B).numpy()
    for fac, storage in ((L, "dense"), (pb, "packed"), (L, "packed")):
        c = SchurAssemblyConfig(block_size=8, use_kernels=True, fused=True,
                                storage=storage)
        _close(assemble_schur(fac, B, meta, c, block_mask=pb.index.mask)
               .numpy(), base)


@pytest.mark.parametrize("extra", [
    ["--storage", "packed", "--kernels"],
    ["--fused"],
    ["--storage", "packed", "--fused", "--mode", "implicit"],
])
def test_launcher_cpu_smoke_packed_and_fused(extra, capsys):
    rc = solve_feti.main(["--arch", "feti-heat-2d", "--smoke", "--device",
                          "cpu", "--validate", *extra])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "converged=True" in out and "rel err vs global solve" in out
    storage = "packed" if "packed" in extra else "dense"
    assert f"storage={storage} device bytes" in out
    assert "dense L would be" in out
    assert ("fused=True" in out) == ("--fused" in extra)


CUDA_CASES = [
    # n, m, bs, bm, S, empty columns
    (300, 100, 64, 32, 3, 0),  # ragged: n 300 -> 320, m 100 -> 128
    (256, 96, 128, 32, 2, 32),  # last stripe all padding: start_block = nb
    (520, 258, 128, 128, 2, 0),  # the full-size bs/bm, 3 stripes
    (600, 200, 64, 96, 3, 10),  # uneven starts, the last stripe empty
    (520, 258, 128, 128, 256, 0),  # items many times the resident grid
    # the small blocks of the smoke configurations: 8-deep chunks, TRSM
    # items spanning several stripes, SYRK tiles narrower than a TRSM item
    (61, 30, 8, 8, 2, 0),  # n 61 -> 64, m 30 -> 32
    (200, 90, 8, 8, 3, 10),  # m 90 -> 96: the last 32-column item clipped
    (250, 75, 16, 16, 2, 5),  # bs 16: 16-deep chunks
    (130, 44, 24, 8, 2, 4),  # bs 24: 8-deep chunks
    # blocks over 128 rows: two passes of the TRSM core
    (520, 258, 256, 256, 2, 0),  # bs = bm = 256
    (600, 200, 200, 40, 2, 10),  # bs 200: a second pass of 72 rows
] + [
    # the fused kernels' SYRK groups (64 // bm stripes when bm < 64)
    (400, 258, 16, 16, 2, 6),  # m 258 -> 272: 17 stripes, a ragged last group
    (300, 140, 24, 24, 2, 4),  # m 140 -> 144: groups 48 wide, off the tiles
    (320, 200, 40, 40, 2, 8),  # bm 40: a group is one stripe
    (300, 264, 8, 8, 2, 0),  # 33 stripes in groups of 8, the last one stripe
]


def _rel(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B3", "B4", "B5"])
@pytest.mark.parametrize("n,m,bs,bm,S,empty", CUDA_CASES)
def test_cuda_kernels_match_plain_and_twin(n, m, bs, bm, S, empty, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    L, pb, B, meta = _case(n, m, bs, bm, S, empty, seed=n + bs, device=dev)
    _, _, n_pad, m_pad = ops._padded_sizes(meta)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts = ops._starts(meta, dev)
    Lp = ops.pad_factor(L, n_pad)
    dense = (ops.invert_diag_blocks(Lp, bs), Lp)
    packed = ops._packed_operands(pb, meta)
    wrapper, plain, operands, extra = {
        "B3": (stepped_trsm_packed_kernel, stepped_trsm_packed_plain, packed,
               {}),
        "B4": (stepped_trsm_syrk_kernel, stepped_trsm_syrk_plain, dense,
               {"order": ops._fused_order(meta, S, dev)}),
        "B5": (stepped_trsm_syrk_packed_kernel, stepped_trsm_syrk_packed_plain,
               packed, {"order": ops._fused_order(meta, S, dev, pb.index)}),
    }[kernel]
    before = wrapper.launches
    got = wrapper(*operands, Bp, starts, bs, bm, **extra)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, plain(*operands, Bp, starts, bs, bm)) <= 1e-11
    # the unfused or dense twin, through the other kernels
    if kernel == "B3":
        twin = stepped_trsm_kernel(*dense, Bp, starts, bs, bm)
    else:
        trsm = (stepped_trsm_kernel(*dense, Bp, starts, bs, bm) if kernel == "B4"
                else stepped_trsm_packed_kernel(*packed, Bp, starts, bs, bm))
        twin = stepped_syrk_kernel(trsm, starts, bs, bm)
        for i in range(m_pad // bm):
            assert torch.all(got[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)
    assert _rel(got, twin) <= 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B4", "B5"])
def test_cuda_fused_back_to_back_launches_are_bit_identical(kernel):
    """The ticket and the ready flags are reset before every launch: a
    second launch on the same inputs gives the same F, bit for bit (each
    output element is summed in a fixed order, whatever block computes
    it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    L, pb, B, meta = _case(520, 258, 128, 128, 64, 0, seed=9, device=dev)
    _, _, n_pad, m_pad = ops._padded_sizes(meta)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts = ops._starts(meta, dev)
    if kernel == "B4":
        Lp = ops.pad_factor(L, n_pad)
        wrapper, operands = (stepped_trsm_syrk_kernel,
                             (ops.invert_diag_blocks(Lp, 128), Lp))
        order = ops._fused_order(meta, 64, dev)
    else:
        wrapper, operands = (stepped_trsm_syrk_packed_kernel,
                             ops._packed_operands(pb, meta))
        order = ops._fused_order(meta, 64, dev, pb.index)
    first = wrapper(*operands, Bp, starts, 128, 128, order=order)
    second = wrapper(*operands, Bp, starts, 128, 128, order=order)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B4", "B5"])
def test_cuda_fused_refuses_a_wrong_item_list(kernel):
    """A CUDA launch needs the item list of its own plan: none, one of
    another length or another dtype is refused before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    L, pb, B, meta = _case(300, 100, 64, 32, 2, 0, seed=5, device=dev)
    _, _, n_pad, m_pad = ops._padded_sizes(meta)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts = ops._starts(meta, dev)
    if kernel == "B4":
        Lp = ops.pad_factor(L, n_pad)
        wrapper, operands = (stepped_trsm_syrk_kernel,
                             (ops.invert_diag_blocks(Lp, 64), Lp))
    else:
        wrapper, operands = (stepped_trsm_syrk_packed_kernel,
                             ops._packed_operands(pb, meta))
    order = ops._fused_order(meta, 2, dev, pb.index if kernel == "B5" else None)
    before = wrapper.launches
    for bad in (None, order[1:], order.long()):
        with pytest.raises(ValueError, match="item list|order must be"):
            wrapper(*operands, Bp, starts, 64, 32, order=bad)
    assert wrapper.launches == before


F32_TOL = 1e-4  # f32 kernel vs its f32 plain version: f32 sums in two orders
F32_CASES = [
    # n, m, bs, bm, S, empty columns: bs 8, 16, 24 and 40 (8-deep chunks
    # where 16 does not divide bs), the full-size bs/bm, and a queue many
    # times the resident grid
    (61, 30, 8, 8, 2, 0),
    (250, 75, 16, 16, 2, 5),
    (130, 44, 24, 8, 2, 4),
    (200, 70, 40, 8, 3, 6),
    (520, 258, 128, 128, 2, 0),
    (520, 258, 128, 128, 256, 0),
    (520, 258, 256, 256, 2, 0),  # bs 256: two passes of the TRSM core
    # the SYRK groups: a ragged last group, 48-wide groups, one stripe a
    # group at bm 40, groups of 8 stripes with a last one of one
    (400, 258, 16, 16, 2, 6),
    (300, 140, 24, 24, 2, 4),
    (320, 200, 40, 40, 2, 8),
    (300, 264, 8, 8, 2, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B4", "B5"])
@pytest.mark.parametrize("n,m,bs,bm,S,empty", F32_CASES)
def test_cuda_f32_fused_kernels_match_plain(n, m, bs, bm, S, empty, kernel):
    """The f32 fused kernels (FFMA, f32 accumulation, f32 Y and F) against
    their f32 plain versions (TF32 off) and against the f64 kernel on the
    same f32 operands; each counts one f32 launch and no f64 one, and the
    upper tiles stay exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    L, pb, B, meta = _case(n, m, bs, bm, S, empty, seed=n + bs, device=dev)
    L, pb, B = L.float(), pb.to(torch.float32), B.float()
    _, _, n_pad, m_pad = ops._padded_sizes(meta)
    Bp = ops._pad_to(B, n_pad, m_pad)
    starts = ops._starts(meta, dev)
    if kernel == "B4":
        Lp = ops.pad_factor(L, n_pad)
        wrapper, plain = stepped_trsm_syrk_kernel, stepped_trsm_syrk_plain
        operands = (ops.invert_diag_blocks(Lp, bs), Lp)
        order = ops._fused_order(meta, S, dev)
    else:
        wrapper = stepped_trsm_syrk_packed_kernel
        plain = stepped_trsm_syrk_packed_plain
        operands = ops._packed_operands(pb, meta)
        order = ops._fused_order(meta, S, dev, pb.index)
    before = dict(wrapper.launches_by_dtype)
    got = wrapper(*operands, Bp, starts, bs, bm, order=order)
    torch.cuda.synchronize()
    assert wrapper.launches_by_dtype == dict(before, f32=before["f32"] + 1)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    wide = [t.double() if t.is_floating_point() else t for t in operands]
    f64 = wrapper(*wide, Bp.double(), starts, bs, bm, order=order)
    for want in (plain(*operands, Bp, starts, bs, bm), f64):
        assert _rel(got.double(), want.double()) <= F32_TOL
    for i in range(m_pad // bm):
        assert torch.all(got[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)
