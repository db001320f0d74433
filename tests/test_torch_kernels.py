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
        stepped_trsm_kernel(Linv.float(), L.float(), B.float(), starts, 16, 8)
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
]


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
    with pytest.raises(ValueError, match="multiple of 32"):
        stepped_syrk_kernel(Y, starts.repeat_interleave(bm // 16), bs, 16)
