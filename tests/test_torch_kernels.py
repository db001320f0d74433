"""The port's stepped TRSM/SYRK against the reference's Pallas kernels.

On the CPU the wrappers run their plain torch versions; the reference runs
its Pallas kernels in interpret mode. Same seeded numpy inputs go to both;
tolerance 1e-12 relative to the result's scale (f64, sums in another
order). The ``cuda`` case holds the hand-written kernels against their
plain versions on the card and skips elsewhere; it needs no JAX, so the
card's machine runs it with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build_stepped_meta  # noqa: E402
from repro_torch.kernels.ref import syrk_ref, trsm_ref  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ops,
    stepped_syrk_kernel,
    stepped_syrk_plain,
    stepped_trsm_kernel,
    stepped_trsm_plain,
)

pytestmark = pytest.mark.torch_port

TOL = 1e-12
F32_TOL = 1e-4  # f32 kernel vs its f32 plain version: sums in another order


def _lower_banded(n, bw, rng):
    """Random nonsingular banded lower factor (as repro.testing builds it)."""
    L = np.zeros((n, n))
    for i in range(n):
        lo = max(0, i - bw)
        row = rng.standard_normal(i - lo) * (rng.random(i - lo) < 0.5)
        L[i, lo:i] = row * 0.3
        L[i, i] = 1.0 + rng.random()
    return L


def _feti_like_bt(n, m, rng, empty=0):
    """Random B̃ᵀ with ±1 entries near a random anchor row per column; the
    last ``empty`` columns are all zero (pivot n)."""
    Bt = np.zeros((n, m))
    for j in range(m - empty):
        a = int(rng.integers(0, n))
        for r in np.unique(np.clip(a + rng.integers(0, 5, size=2), 0, n - 1)):
            Bt[r, j] = rng.choice([-1.0, 1.0])
    return Bt


def _case(n, m, bs, bm, S, empty, seed):
    rng = np.random.default_rng(seed)
    Ls = np.stack([_lower_banded(n, 10, rng) for _ in range(S)])
    Bt = _feti_like_bt(n, m, rng, empty)
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    Bp = np.broadcast_to(Bt[:, meta.perm], (S, n, m)).copy()
    return Ls, Bp, meta


CASES = [
    # n, m, bs, bm, S, empty columns
    (64, 32, 16, 8, 1, 0),
    (60, 28, 16, 8, 2, 0),  # n padded 60 -> 64, m padded 28 -> 32
    (96, 40, 32, 16, 1, 16),  # last stripe all empty: start_block = nb
    (128, 64, 32, 32, 3, 0),  # batched S
    (512, 96, 256, 32, 2, 0),  # bs 256, the reference planner's largest
]


def _reference_ops():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import build_stepped_meta as ref_meta
    from repro.kernels import ops as ref_ops

    return jnp, ref_meta, ref_ops


def _close(got, want):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("n,m,bs,bm,S,empty", CASES)
def test_plain_trsm_matches_reference(n, m, bs, bm, S, empty):
    jnp, ref_meta, ref_ops = _reference_ops()
    Ls, Bp, meta = _case(n, m, bs, bm, S, empty, seed=n + m)
    got = ops.stepped_trsm(torch.from_numpy(Ls), torch.from_numpy(Bp), meta)
    rmeta = ref_meta(Bp[0] != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    for s in range(S):
        want = ref_ops.stepped_trsm(jnp.asarray(Ls[s]), jnp.asarray(Bp[s]),
                                    rmeta, interpret=True)
        _close(got[s].numpy(), np.asarray(want))
    _close(got.numpy(), trsm_ref(torch.from_numpy(Ls), torch.from_numpy(Bp)).numpy())


@pytest.mark.parametrize("n,m,bs,bm,S,empty", CASES)
def test_plain_syrk_matches_reference(n, m, bs, bm, S, empty):
    jnp, ref_meta, ref_ops = _reference_ops()
    Ls, Bp, meta = _case(n, m, bs, bm, S, empty, seed=n * m)
    Y = trsm_ref(torch.from_numpy(Ls), torch.from_numpy(Bp)).numpy()
    got = ops.stepped_syrk(torch.from_numpy(Y), meta)
    _close(got.numpy(), syrk_ref(torch.from_numpy(Y)).numpy())
    rmeta = ref_meta(Bp[0] != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    for s in range(S):
        want = ref_ops.stepped_syrk(jnp.asarray(Y[s]), rmeta, interpret=True)
        _close(got[s].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[s].numpy(), got[s].numpy().T)


GROUP = 128  # F columns a block of the CUDA stepped SYRK covers


def _syrk_by_groups(Y, starts, bs, bm):
    """The CUDA stepped SYRK's schedule in numpy: F in groups of
    ``GROUP // bm`` stripes (one when bm >= GROUP), group (gi, gj <= gi)
    reducing from its first row stripe's start; the row panel is masked at
    each column's own stripe start, the column panel only in a diagonal
    group (it is the row panel there); only entries of stripe pairs
    (i, j <= i) are kept."""
    S, n, m = Y.shape
    col_start = np.repeat(np.minimum(starts, n // bs) * bs, bm)
    masked = Y * (np.arange(n)[:, None] >= col_start[None, :])
    width = max(1, GROUP // bm) * bm
    F = np.zeros((S, m, m))
    for r0 in range(0, m, width):
        rows = slice(r0, min(r0 + width, m))
        k0 = col_start[r0]
        for c0 in range(0, r0 + 1, width):
            cols = slice(c0, min(c0 + width, m))
            right = masked if c0 == r0 else Y
            F[:, rows, cols] = (masked[:, k0:, rows].transpose(0, 2, 1)
                                @ right[:, k0:, cols])
    stripe = np.arange(m) // bm
    return F * (stripe[:, None] >= stripe[None, :])


@pytest.mark.parametrize("noise", [False, True],
                         ids=["stepped-Y", "nonzero-above-starts"])
@pytest.mark.parametrize("bs", [8, 16])
def test_syrk_groups_match_reference(bs, noise):
    """The CUDA stepped SYRK's design premise against the TPU kernel: a
    block that covers a group of stripes, reduces from its first row
    stripe's start and masks every Y column at its own stripe's start
    computes what ``stepped_syrk_pallas`` computes tile by tile, for the
    reference's stepped Y and for a Y with nonzeros above every start,
    and leaves every upper tile zero."""
    jnp, ref_meta, ref_ops = _reference_ops()
    from repro.kernels.stepped_syrk import stepped_syrk_pallas

    bm, n, m, S = bs, 96, 150, 2  # 19 or 10 stripes: two groups
    Ls, Bp, _ = _case(n, m, bs, bm, S, empty=bm + 3, seed=bs + noise)
    rmeta = ref_meta(Bp[0] != 0, block_size=bs, rhs_block_size=bm,
                     presorted=True)
    n_pad, m_pad = -(-n // bs) * bs, -(-m // bm) * bm
    starts = np.asarray(ref_ops._start_blocks(rmeta, bm, bs, m_pad, n_pad))
    assert m_pad > GROUP // bm * bm and np.all(np.diff(starts) >= 0)
    assert starts[-1] == n_pad // bs and len(set(starts.tolist())) > 3
    Y = np.zeros((S, n_pad, m_pad))
    for s in range(S):
        Y[s, :n, :m] = np.asarray(ref_ops.stepped_trsm(
            jnp.asarray(Ls[s]), jnp.asarray(Bp[s]), rmeta, interpret=True))
    if noise:
        rng = np.random.default_rng(bs)
        above = np.arange(n_pad)[:, None] < np.repeat(starts * bs, bm)[None]
        Y += rng.standard_normal(Y.shape) * above
    got = _syrk_by_groups(Y, starts, bs, bm)
    for s in range(S):
        want = np.asarray(stepped_syrk_pallas(
            jnp.asarray(Y[s]), jnp.asarray(starts, dtype=jnp.int32), bs=bs,
            bm=bm, interpret=True))
        _close(got[s], want)
    _close(got, stepped_syrk_plain(torch.from_numpy(Y),
                                   torch.from_numpy(starts), bs, bm).numpy())
    for i in range(m_pad // bm):
        assert np.all(got[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)


def test_start_blocks_and_empty_stripe():
    _, ref_meta, ref_ops = _reference_ops()
    _, Bp, meta = _case(96, 40, 32, 16, 1, 16, seed=7)
    rmeta = ref_meta(Bp[0] != 0, block_size=32, rhs_block_size=16,
                     presorted=True)
    got = ops._start_blocks(meta, 16, 32, 48, 96)
    np.testing.assert_array_equal(got, ref_ops._start_blocks(rmeta, 16, 32,
                                                             48, 96))
    assert got[-1] == 96 // 32  # the all-empty stripe starts past the end


def test_invert_diag_blocks_matches_reference():
    jnp, _, ref_ops = _reference_ops()
    rng = np.random.default_rng(5)
    Ls = np.stack([_lower_banded(64, 10, rng) for _ in range(2)])
    got = ops.invert_diag_blocks(torch.from_numpy(Ls), 16).numpy()
    for s in range(2):
        want = np.asarray(ref_ops.invert_diag_blocks(jnp.asarray(Ls[s]), 16))
        _close(got[s], want)


def test_mirror_lower_and_zero_upper_tiles():
    jnp, _, ref_ops = _reference_ops()
    rng = np.random.default_rng(6)
    Y = torch.from_numpy(rng.standard_normal((2, 64, 48)))
    starts = torch.tensor([0, 1, 2], dtype=torch.int32)
    Fl = stepped_syrk_kernel(Y, starts, bs=16, bm=16)
    for i in range(3):  # upper tiles are exact zeros
        assert torch.all(Fl[:, i * 16:(i + 1) * 16, (i + 1) * 16:] == 0)
    got = ops._mirror_lower(Fl, 16, 48, 40).numpy()
    for s in range(2):
        want = np.asarray(ref_ops._mirror_lower(jnp.asarray(Fl[s].numpy()),
                                                16, 48, 40))
        np.testing.assert_array_equal(got[s], want)


def test_wrappers_check_operands():
    Ls, Bp, meta = _case(64, 32, 16, 8, 1, 0, seed=3)
    L = torch.from_numpy(Ls)
    Linv = ops.invert_diag_blocks(L, 16)
    B = torch.from_numpy(Bp)
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float64"):
        stepped_trsm_kernel(Linv.half(), L.half(), B.half(), starts, 16, 8)
    with pytest.raises(TypeError, match="several dtypes"):
        stepped_trsm_kernel(Linv.float(), L, B, starts, 16, 8)
    with pytest.raises(ValueError, match="padded"):
        stepped_trsm_kernel(Linv, L, B[:, :, :30].contiguous(), starts, 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        stepped_syrk_kernel(B.mT.mT.transpose(1, 2), starts[:1], 16, 32)
    before = stepped_trsm_kernel.launches
    stepped_trsm_kernel(Linv, L, B, starts, 16, 8)  # CPU: plain version
    assert stepped_trsm_kernel.launches == before


@pytest.mark.parametrize("bs,ok", [(8, True), (128, True), (200, True),
                                   (256, True), (264, False), (12, False),
                                   (0, False)])
def test_cuda_tile_limits(bs, ok):
    """The CUDA TRSM kernels take every block size the reference's planner
    offers, multiples of 8 up to 256, and refuse the rest before any
    launch."""
    from repro_torch.kernels._launch import MAX_BS, check_cuda_tiles

    assert MAX_BS == 256
    if ok:
        check_cuda_tiles(bs, 256)
        check_cuda_tiles(bs, 8)
    else:
        with pytest.raises(ValueError, match="up to 256"):
            check_cuda_tiles(bs, 32)
    with pytest.raises(ValueError, match="multiple of 8"):
        check_cuda_tiles(256, 12)


CUDA_CASES = [
    # n, m, bs, bm, S, empty columns
    (300, 100, 64, 32, 3, 0),  # n padded 300 -> 320, m padded 100 -> 128
    (256, 96, 128, 32, 2, 32),  # last stripe all empty: start_block = nb
    (520, 258, 128, 128, 2, 0),  # the full-size bs/bm, 3 stripes
    (600, 200, 64, 96, 3, 10),  # uneven starts, the last stripe empty
    (520, 258, 128, 128, 256, 0),  # items many times the resident grid
    # the small blocks of the smoke configurations: 8-deep chunks, column
    # tiles spanning several stripes and clipped at m
    (61, 30, 8, 8, 2, 0),  # n 61 -> 64, m 30 -> 32
    (200, 90, 8, 8, 3, 10),  # m 90 -> 96: the last 32-column tile clipped
    (250, 75, 16, 16, 2, 5),  # m 75 -> 80, bs 16: 16-deep chunks
    (130, 44, 24, 8, 2, 4),  # bs 24: 8-deep chunks, 5 stripes in a tile
    (300, 100, 40, 24, 3, 0),  # bs 40 > 32: a second warp owns rows
    # blocks over 128 rows: two passes of the row core
    (520, 258, 256, 256, 2, 0),  # bs = bm = 256: n 520 -> 768, m -> 512
    (600, 200, 200, 40, 2, 10),  # bs 200: a second pass of 72 rows
]


def test_build_sources_select_the_device_code(tmp_path, monkeypatch):
    """``build.sources`` points the kernel build at another copy of csrc/: an
    unchanged copy names the same library, an edited header another, and
    the port's own sources are in use again after the block."""
    import shutil

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "_nvcc_version", lambda: b"nvcc")
    own = build._library_path("stepped_trsm")
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    with build.sources(copy):
        assert build._library_path("stepped_trsm") == own
        header = copy / "tf32x3_f32.cuh"
        header.write_text(header.read_text() + "// a variant\n")
        assert build._library_path("stepped_trsm") != own
        assert build._library_path("stepped_trsm", build.CSRC) == own
    assert build._library_path("stepped_trsm") == own


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,bs,bm,S,empty", CUDA_CASES)
def test_cuda_kernels_match_plain(n, m, bs, bm, S, empty):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Ls, Bp, meta = _case(n, m, bs, bm, S, empty, seed=n)
    dev = torch.device("cuda")
    n_pad, m_pad = -(-n // bs) * bs, -(-m // bm) * bm
    Lp = ops.pad_factor(torch.from_numpy(Ls).to(dev), n_pad)
    B = ops._pad_to(torch.from_numpy(Bp).to(dev), n_pad, m_pad)
    starts = torch.as_tensor(ops._start_blocks(meta, bm, bs, m_pad, n_pad),
                             device=dev)
    Linv = ops.invert_diag_blocks(Lp, bs)
    t0, s0 = stepped_trsm_kernel.launches, stepped_syrk_kernel.launches
    Y = stepped_trsm_kernel(Linv, Lp, B, starts, bs, bm)
    F = stepped_syrk_kernel(Y, starts, bs, bm)
    torch.cuda.synchronize()
    assert stepped_trsm_kernel.launches == t0 + 1
    assert stepped_syrk_kernel.launches == s0 + 1
    Y_plain = stepped_trsm_plain(Linv, Lp, B, starts, bs, bm)
    F_plain = stepped_syrk_plain(Y_plain, starts, bs, bm)
    for got, want in ((Y, Y_plain), (F, F_plain)):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-11 * scale
    for i in range(m_pad // bm):
        assert torch.all(F[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        stepped_syrk_kernel(Y, starts.repeat_interleave(bm // 4), bs, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 24, 40])
def test_cuda_syrk_any_block_size(bs):
    """The stepped SYRK streams Y in 16-row chunks; a bs that is no
    multiple of 16 clips the last chunk to n."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(bs)
    S, bm, nb = 3, 32, 7
    n, m = nb * bs, 3 * bm
    starts = torch.tensor([0, 2, 5], dtype=torch.int32)
    Y = torch.from_numpy(rng.standard_normal((S, n, m)))
    for c, st in enumerate(starts.tolist()):  # zero above each start
        Y[:, :st * bs, c * bm:(c + 1) * bm] = 0
    dev = torch.device("cuda")
    got = stepped_syrk_kernel(Y.to(dev), starts.to(dev), bs, bm).cpu()
    want = stepped_syrk_plain(Y, starts, bs, bm)
    assert (got - want).abs().max().item() <= 1e-11 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("bm", [8, 16, 24, 40, 128])
def test_cuda_syrk_groups_match_plain(bm, dtype):
    """The stepped SYRK's blocks cover groups of 128 // bm stripes (bm <
    128) and mask every Y column at its own stripe's start: on a Y that is
    nonzero above every start (the masks must drop those terms), with
    several groups, the last clipped at m, and an empty last stripe, it
    matches its plain version (1e-11 at f64, 1e-4 at f32), and every upper
    tile, those inside a diagonal group too, is exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(bm)
    S, bs, nb = 3, 16, 12
    nc = -(-300 // bm)
    n, m = nb * bs, nc * bm
    starts = np.sort(rng.integers(0, nb, size=nc))
    starts[-1] = nb
    dev = torch.device("cuda")
    Y = torch.from_numpy(rng.standard_normal((S, n, m))).to(dev, dtype)
    st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    key = "f64" if dtype == torch.float64 else "f32"
    before = stepped_syrk_kernel.launches_by_dtype[key]
    got = stepped_syrk_kernel(Y, st, bs, bm)
    torch.cuda.synchronize()
    assert stepped_syrk_kernel.launches_by_dtype[key] == before + 1
    want = stepped_syrk_plain(Y, st, bs, bm)
    tol = 1e-11 if dtype == torch.float64 else F32_TOL
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    for i in range(nc):
        assert torch.all(got[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_misaligned_operands():
    """The kernels move operands in 16-byte copies: a contiguous view that
    starts 8 bytes into its storage is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    S, n, m, bs, bm = 1, 64, 32, 32, 32
    buf = torch.zeros(S * n * m + 1, dtype=torch.float64, device=dev)
    Y = buf[1:].view(S, n, m)
    assert Y.is_contiguous() and Y.data_ptr() % 16 == 8
    starts = torch.zeros(1, dtype=torch.int32, device=dev)
    before = stepped_syrk_kernel.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        stepped_syrk_kernel(Y, starts, bs, bm)
    L = torch.eye(n, dtype=torch.float64, device=dev)[None].contiguous()
    Linv = ops.invert_diag_blocks(L, bs)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stepped_trsm_kernel(Linv, L, Y, starts, bs, bm)
    assert stepped_syrk_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,bs,bm,S,empty", CUDA_CASES)
def test_cuda_f32_kernels_match_plain(n, m, bs, bm, S, empty):
    """The f32 stepped TRSM, packed TRSM and stepped SYRK against their f32
    plain versions (FFMA against cuBLAS SGEMM with TF32 off) and against
    the f64 kernels on the same f32 operands; each counts an f32 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import (
        stepped_trsm_packed_kernel,
        stepped_trsm_packed_plain,
    )
    from repro_torch.sparse import PackedBlockIndex, pack_factor

    torch.backends.cuda.matmul.allow_tf32 = False
    Ls, Bp, meta = _case(n, m, bs, bm, S, empty, seed=n + 1)
    dev = torch.device("cuda")
    n_pad, m_pad = -(-n // bs) * bs, -(-m // bm) * bm
    L32 = torch.from_numpy(Ls).float().to(dev)
    Lp = ops.pad_factor(L32, n_pad)
    B = ops._pad_to(torch.from_numpy(Bp).float().to(dev), n_pad, m_pad)
    starts = torch.as_tensor(ops._start_blocks(meta, bm, bs, m_pad, n_pad),
                             device=dev)
    Linv = ops.invert_diag_blocks(Lp, bs)
    nb = n_pad // bs
    # every block that is nonzero in some subdomain
    mask = (Lp.reshape(S, nb, bs, nb, bs).abs().sum(dim=(0, 2, 4)) > 0
            ).cpu().numpy()
    packed = pack_factor(L32, PackedBlockIndex.from_mask(mask, n, bs))
    pops = (Linv, packed.values, torch.as_tensor(packed.index.rowptr,
                                                 device=dev),
            torch.as_tensor(packed.index.cols, device=dev))
    counts = {k: dict(w.launches_by_dtype) for k, w in (
        ("trsm", stepped_trsm_kernel), ("packed", stepped_trsm_packed_kernel),
        ("syrk", stepped_syrk_kernel))}
    Y = stepped_trsm_kernel(Linv, Lp, B, starts, bs, bm)
    Yp = stepped_trsm_packed_kernel(*pops, B, starts, bs, bm)
    F = stepped_syrk_kernel(Y, starts, bs, bm)
    torch.cuda.synchronize()
    for key, w in (("trsm", stepped_trsm_kernel),
                   ("packed", stepped_trsm_packed_kernel),
                   ("syrk", stepped_syrk_kernel)):
        assert w.launches_by_dtype["f32"] == counts[key]["f32"] + 1
        assert w.launches_by_dtype["f64"] == counts[key]["f64"]
    assert Y.dtype == Yp.dtype == F.dtype == torch.float32
    Y_plain = stepped_trsm_plain(Linv, Lp, B, starts, bs, bm)
    d = lambda t: t.double()  # noqa: E731
    Y64 = stepped_trsm_kernel(d(Linv), d(Lp), d(B), starts, bs, bm)
    for got, want in ((Y, Y_plain),
                      (Yp, stepped_trsm_packed_plain(*pops, B, starts, bs,
                                                     bm)),
                      (F, stepped_syrk_plain(Y, starts, bs, bm)),
                      (d(Y), Y64), (d(Yp), Y64),
                      (d(F), stepped_syrk_kernel(d(Y), starts, bs, bm))):
        scale = want.abs().max().item()
        assert (d(got) - d(want)).abs().max().item() <= F32_TOL * scale
    for i in range(m_pad // bm):
        assert torch.all(F[:, i * bm:(i + 1) * bm, (i + 1) * bm:] == 0)


def _block_sparse_lower(nb, bs, S, rng, empty_row):
    """(S, nb bs, nb bs) lower factors on a random block mask shared by all
    S, a third of the blocks below the diagonal, block row ``empty_row``
    with none; diagonal blocks lower triangular with 1 + U(0, 1) on their
    diagonal. Returns the factors and the (nb, nb) mask."""
    n = nb * bs
    mask = np.tril(rng.random((nb, nb)) < 0.35, -1)
    mask[empty_row] = False
    mask |= np.eye(nb, dtype=bool)
    L = np.zeros((S, n, n))
    for k, j in zip(*np.nonzero(mask)):
        blk = rng.standard_normal((S, bs, bs)) * (0.3 / np.sqrt(bs))
        if k == j:
            blk = np.tril(blk, -1) + np.eye(bs) * (1 + rng.random((S, 1, bs)))
        L[:, k * bs:(k + 1) * bs, j * bs:(j + 1) * bs] = blk
    return L, mask


# n, m, bs, bm, S, empty columns of the packed f32 TRSM's cluster core:
# clusters of 1 (bm 24), 2 (64) and 4 (128) column tiles, and two clusters
# of 4 a stripe (256); chunks 8 (bs 24, 40, 200), 16 (bs 48) and 32 (bs
# 128, 256) deep, one pass or two
CLUSTER_CASES = [
    (216, 100, 24, 24, 2, 0),  # m 100 -> 120: the last 32-column tile ragged
    (400, 200, 40, 64, 3, 64),  # the last stripe all empty: start = nb
    (288, 130, 48, 128, 2, 128),  # 16-deep chunks, the last stripe empty
    (640, 258, 128, 128, 256, 0),  # many times the resident clusters
    (600, 300, 200, 256, 2, 0),  # two passes, the second of 72 rows
    (768, 258, 256, 256, 2, 0),  # two full passes
]
# the column tiles a cluster takes at each bm of CLUSTER_CASES
CLUSTER_TILES = {24: 1, 64: 2, 128: 4, 256: 4}


@pytest.mark.parametrize("n,m,bs,bm,S,empty", CLUSTER_CASES)
def test_plain_packed_trsm_at_cluster_shapes_matches_reference(n, m, bs, bm,
                                                               S, empty):
    """The packed TRSM's CPU path at the cluster core's shapes (a ragged
    last tile, an empty last stripe, a block row with no slot left of its
    diagonal, one pass or two) against the reference's Pallas kernel in
    interpret mode on the same f64 operands (TOL), on the first two
    subdomains of each case: the plain version that
    test_cuda_f32_packed_trsm_clusters holds the cluster core to is itself
    held to the reference at those shapes."""
    jnp, _, _ = _reference_ops()
    from repro.kernels.stepped_trsm import stepped_trsm_packed_pallas

    from repro_torch.kernels import stepped_trsm_packed_kernel
    from repro_torch.sparse import PackedBlockIndex, pack_factor

    S = min(S, 2)
    rng = np.random.default_rng(n + bs)
    nb = n // bs
    L, mask = _block_sparse_lower(nb, bs, S, rng, empty_row=nb // 2)
    Bt = _feti_like_bt(n, m, rng, empty)
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    m_pad = -(-m // bm) * bm
    B = ops._pad_to(torch.from_numpy(
        np.broadcast_to(Bt[:, meta.perm], (S, n, m)).copy()), n, m_pad)
    starts_np = ops._start_blocks(meta, bm, bs, m_pad, n).astype(np.int32)
    L64 = torch.from_numpy(L)
    packed = pack_factor(L64, PackedBlockIndex.from_mask(mask, n, bs))
    rowptr = np.asarray(packed.index.rowptr, np.int32)
    cols = np.asarray(packed.index.cols, np.int32)
    Linv = ops.invert_diag_blocks(L64, bs)
    before = stepped_trsm_packed_kernel.launches
    got = stepped_trsm_packed_kernel(
        Linv, packed.values, torch.from_numpy(rowptr), torch.from_numpy(cols),
        B, torch.from_numpy(starts_np), bs, bm)
    assert stepped_trsm_packed_kernel.launches == before  # CPU: plain version
    for s in range(S):
        want = stepped_trsm_packed_pallas(
            jnp.asarray(Linv[s].numpy()), jnp.asarray(packed.values[s].numpy()),
            jnp.asarray(rowptr), jnp.asarray(cols), jnp.asarray(B[s].numpy()),
            jnp.asarray(starts_np), bs=bs, bm=bm, interpret=True)
        _close(got[s].numpy(), np.asarray(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,bs,bm,S,empty", CLUSTER_CASES)
def test_cuda_f32_packed_trsm_clusters(n, m, bs, bm, S, empty):
    """The packed f32 TRSM's cluster core against its plain version (1e-4)
    and the f64 kernel on the same f32 operands (1e-5) on a block-sparse
    factor with a block row that stores nothing left of its diagonal (no
    slot right of any start above it): rows above each stripe's start
    exactly zero, one f32 launch counted, and the C launcher's cluster size
    the one stated for bm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from repro_torch.kernels import (
        build,
        stepped_trsm_packed_kernel,
        stepped_trsm_packed_plain,
    )
    from repro_torch.sparse import PackedBlockIndex, pack_factor

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n + bs)
    nb = n // bs
    L, mask = _block_sparse_lower(nb, bs, S, rng, empty_row=nb // 2)
    Bt = _feti_like_bt(n, m, rng, empty)
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    dev = torch.device("cuda")
    m_pad = -(-m // bm) * bm
    L32 = torch.from_numpy(L).float().to(dev)
    B = ops._pad_to(torch.from_numpy(
        np.broadcast_to(Bt[:, meta.perm], (S, n, m)).copy()).float().to(dev),
        n, m_pad)
    starts_np = ops._start_blocks(meta, bm, bs, m_pad, n)
    if empty >= bm:
        assert starts_np[-1] == nb
    starts = torch.as_tensor(starts_np, device=dev)
    packed = pack_factor(L32, PackedBlockIndex.from_mask(mask, n, bs))
    pops = (ops.invert_diag_blocks(L32, bs), packed.values,
            torch.as_tensor(packed.index.rowptr, device=dev),
            torch.as_tensor(packed.index.cols, device=dev))
    fn = build.load("stepped_trsm").stepped_trsm_cluster_tiles
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert fn(bm) == CLUSTER_TILES[bm]
    before = dict(stepped_trsm_packed_kernel.launches_by_dtype)
    got = stepped_trsm_packed_kernel(*pops, B, starts, bs, bm)
    torch.cuda.synchronize()
    assert stepped_trsm_packed_kernel.launches_by_dtype == {
        "f64": before["f64"], "f32": before["f32"] + 1}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = stepped_trsm_packed_plain(*pops, B, starts, bs, bm)
    wide = [t.double() if t.is_floating_point() else t for t in pops]
    twin = stepped_trsm_packed_kernel(*wide, B.double(), starts, bs, bm)
    for ref, tol in ((want, F32_TOL), (twin, F64_GAP)):
        scale = ref.abs().max().item()
        assert (got.double() - ref.double()).abs().max().item() <= tol * scale
    for c, st in enumerate(starts_np.tolist()):
        assert torch.all(got[:, :st * bs, c * bm:(c + 1) * bm] == 0)


# n, m, bs, bm: the small-block core (bs 8, 16), the row-split core's 8-
# and 16-deep chunks (bs 24, 40, 128), and the packed f32 TRSM's clusters
# of 2 (bm 64) and 4 (bm 128; bm 256: two a stripe), in one pass and in two
F32_ACCURACY_CASES = [
    (200, 90, 8, 8),
    (250, 75, 16, 16),
    (130, 44, 24, 8),
    (300, 100, 40, 24),
    (520, 258, 128, 128),
    (400, 200, 40, 64),
    (600, 300, 200, 256),
    (520, 258, 256, 256),
]
F64_GAP = 1e-5  # f32 kernel vs the f64 kernel on the same f32 operands


def _low_bits(shape, rng):
    """±(1 + k 2^-18), k in [1, 127]: f32 values whose low mantissa bits a
    TF32 product (10-bit mantissa) rounds away and a 3xTF32 one keeps."""
    k = rng.integers(1, 128, size=shape)
    return rng.choice([-1.0, 1.0], size=shape) * (1.0 + k * 2.0 ** -18)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,bs,bm", F32_ACCURACY_CASES)
def test_cuda_f32_trsm_keeps_f32_accuracy(n, m, bs, bm):
    """The f32 TRSM core's 3xTF32 products keep f32 accuracy: the stepped
    TRSM (B1), the packed one (B3) and both fused kernels (B4, B5) at f32
    stay within 1e-5 of the f64 kernels on the same f32 operands, whose
    factor and right-hand side entries are ±(1 + k 2^-18) times a power of
    two. One TF32 product rounds each such entry to its power of two, about
    1e-4 off: it fails here, as it would miss by far the f64 kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import (
        stepped_trsm_packed_kernel,
        stepped_trsm_syrk_kernel,
        stepped_trsm_syrk_packed_kernel,
    )
    from repro_torch.sparse import PackedBlockIndex, pack_factor

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(bs)
    S, band = 2, 40
    # diagonal 2 (1 + k 2^-18); half the band below it ±(1 + k 2^-18) / 8
    L = np.zeros((S, n, n))
    for i in range(n):
        lo = max(0, i - band)
        keep = rng.random((S, i - lo)) < 0.5
        L[:, i, lo:i] = 0.125 * _low_bits((S, i - lo), rng) * keep
        L[:, i, i] = 2.0 * np.abs(_low_bits((S,), rng))
    Bt = _feti_like_bt(n, m, rng) * np.abs(_low_bits((n, m), rng))
    meta = build_stepped_meta(Bt != 0, block_size=bs, rhs_block_size=bm)
    Bp = np.broadcast_to(Bt[:, meta.perm], (S, n, m)).copy()
    dev = torch.device("cuda")
    n_pad, m_pad = -(-n // bs) * bs, -(-m // bm) * bm
    L32 = torch.from_numpy(L).float().to(dev)
    Lp = ops.pad_factor(L32, n_pad)
    B = ops._pad_to(torch.from_numpy(Bp).float().to(dev), n_pad, m_pad)
    starts = torch.as_tensor(ops._start_blocks(meta, bm, bs, m_pad, n_pad),
                             device=dev)
    Linv = ops.invert_diag_blocks(Lp, bs)
    nb = n_pad // bs
    mask = (Lp.reshape(S, nb, bs, nb, bs).abs().sum(dim=(0, 2, 4)) > 0
            ).cpu().numpy()
    packed = pack_factor(L32, PackedBlockIndex.from_mask(mask, n, bs))
    pops = (Linv, packed.values, torch.as_tensor(packed.index.rowptr,
                                                 device=dev),
            torch.as_tensor(packed.index.cols, device=dev))
    order = ops._fused_order(meta, S, dev)
    packed_order = ops._fused_order(meta, S, dev, packed.index)

    def d(ts):  # the same values at f64
        return [t.double() if t.is_floating_point() else t for t in ts]

    runs = {
        "B1": lambda ts: stepped_trsm_kernel(*ts, B.to(ts[0].dtype), starts,
                                             bs, bm),
        "B3": lambda ts: stepped_trsm_packed_kernel(*ts, B.to(ts[0].dtype),
                                                    starts, bs, bm),
        "B4": lambda ts: stepped_trsm_syrk_kernel(
            *ts, B.to(ts[0].dtype), starts, bs, bm, order=order),
        "B5": lambda ts: stepped_trsm_syrk_packed_kernel(
            *ts, B.to(ts[0].dtype), starts, bs, bm, order=packed_order),
    }
    operands = {"B1": (Linv, Lp), "B3": pops, "B4": (Linv, Lp), "B5": pops}
    for name, run in runs.items():
        got = run(list(operands[name]))
        want = run(d(operands[name]))
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        rel = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert rel <= F64_GAP, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [16, 128])
def test_cuda_f32_syrk_keeps_f32_accuracy(bm):
    """The f32 stepped SYRK's 3xTF32 products keep f32 accuracy: within
    1e-5 of the f64 kernel on the same f32 operands ±(1 + k 2^-18), over a
    reduction 2,048 rows deep. One TF32 product rounds each operand to ±1:
    the same product on operands so rounded lands more than 1e-5 off, as
    checked here on the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(bm + 1)
    S, bs, nb = 2, 16, 128
    nc = -(-300 // bm)
    starts = np.sort(rng.integers(0, nb // 2, size=nc))
    dev = torch.device("cuda")
    Y = torch.from_numpy(_low_bits((S, nb * bs, nc * bm), rng)).float().to(dev)
    st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    got = stepped_syrk_kernel(Y, st, bs, bm)
    want = stepped_syrk_kernel(Y.double(), st, bs, bm)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()

    def rel(a):
        return ((a.double() - want).abs().max() / want.abs().max()).item()

    assert rel(got) <= F64_GAP, rel(got)
    # TF32 keeps 10 of f32's 23 mantissa bits: round the other 13 away
    tf32 = ((Y.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    assert rel(stepped_syrk_plain(tf32.double(), st, bs, bm)) > F64_GAP
