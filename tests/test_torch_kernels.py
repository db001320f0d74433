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



F32_TOL = 1e-4  # f32 kernel vs its f32 plain version: sums in another order


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


# n, m, bs, bm: the small-block core (bs 8, 16) and the row-split core's 8-
# and 16-deep chunks (bs 24, 40, 128)
F32_ACCURACY_CASES = [
    (200, 90, 8, 8),
    (250, 75, 16, 16),
    (130, 44, 24, 8),
    (300, 100, 40, 24),
    (520, 258, 128, 128),
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
