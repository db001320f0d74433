"""The LM path's layers against the reference's on identical inputs: norms,
every MLP kind (tanh GeLU), RoPE and M-RoPE, ``flash_attention`` (causal,
windowed, ``kv_valid``, ragged chunks, ``skip_masked_blocks``, a wholly
masked chunk), the RG-LRU scan and block, the chunked RWKV-6 evaluation and
its blocks, all with state.

Weights are the seeded numpy draws of ``repro_torch.interop.random_lm_state``
for a smoke config (a layer's slice of them), inputs seeded numpy; both
packages get the identical values. Tolerances (max over elements, over the
reference's largest entry), measured here: every f32 case within 1e-6 (the
worst 9.7e-7, the chunked RWKV evaluation at chunk 64), bar 1e-5; the bf16
layernorm bit-equal, bar 2e-2."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _nest(flat):
    """{"a.b": x} -> {"a": {"b": x}} (the reference's params layout)."""
    out = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def _layer(arch, prefix, dtype="float32", layer=0):
    """(port config, reference config, numpy weights under ``prefix`` of
    layer ``layer`` of ``arch``'s smoke config)."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import random_lm_state

    kw = dict(dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    rcfg = dataclasses.replace(ref_smoke(arch), **kw)
    full = f"blocks.{layer}.{prefix}."
    state = {k[len(full):]: v for k, v in random_lm_state(cfg).items()
             if k.startswith(full)}
    assert state
    return cfg, rcfg, state


def _port(module, state, dtype):
    module.load_state_dict({k: torch.from_numpy(v).to(dtype)
                            for k, v in state.items()})
    return module


def _ref(state, dtype):
    import jax.numpy as jnp

    return _nest({k: jnp.asarray(v, dtype) for k, v in state.items()})


def _init(dtype=torch.float32):
    from repro_torch.models.layers import Init

    return Init(torch.device("cpu"), dtype, torch.Generator().manual_seed(0))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------------ layers ----
@pytest.mark.parametrize("arch,dtype,tol", [
    ("granite-3-8b", "float32", F32_TOL),  # rmsnorm
    ("hubert-xlarge", "float32", F32_TOL),  # layernorm
    ("rwkv6-1.6b", "bfloat16", BF16_TOL),  # layernorm at bf16
])
def test_norm_matches_reference(arch, dtype, tol):
    import jax.numpy as jnp

    from repro.models.layers import apply_norm
    from repro_torch.models.layers import DTYPES, Norm

    cfg, _, state = _layer(arch, "norm1", dtype)
    tdt = DTYPES[dtype]
    norm = _port(Norm(cfg.d_model, cfg.norm, cfg.norm_eps, _init(tdt)),
                 state, tdt)
    x = _x((2, 5, cfg.d_model), scale=3.0) + 1.0  # an offset mean
    got = norm(torch.from_numpy(x).to(tdt))
    want = apply_norm(_ref(state, getattr(jnp, dtype)),
                      jnp.asarray(x, getattr(jnp, dtype)), cfg.norm,
                      cfg.norm_eps)
    assert got.dtype == tdt
    assert _rel(got, np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("arch,kind", [
    ("granite-3-8b", "swiglu"), ("recurrentgemma-2b", "geglu"),
    ("nemotron-4-340b", "squared_relu"), ("hubert-xlarge", "gelu"),
])
def test_mlp_matches_reference(arch, kind):
    import jax.numpy as jnp

    from repro.models.layers import mlp
    from repro_torch.models.layers import MLP

    cfg, _, state = _layer(arch, "mlp")
    assert cfg.mlp_kind == kind
    assert ("wi.b" in state) == cfg.mlp_bias
    m = _port(MLP(cfg.d_model, cfg.d_ff, kind, _init(), cfg.mlp_bias), state,
              torch.float32)
    x = _x((2, 7, cfg.d_model), seed=1)
    got = m(torch.from_numpy(x))
    want = mlp(_ref(state, jnp.float32), jnp.asarray(x), kind)
    assert _rel(got, want) < F32_TOL


def test_gelu_is_the_tanh_approximation():
    import jax

    from repro_torch.models.layers import gelu

    x = np.linspace(-6, 6, 401).astype(np.float32)
    got = gelu(torch.from_numpy(x)).numpy()
    assert _rel(got, jax.nn.gelu(x)) < 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - got).max() > 1e-4  # torch's default is not it


def test_rope_and_mrope_match_reference():
    import jax.numpy as jnp

    from repro.models.layers import apply_mrope as ref_mrope
    from repro.models.layers import apply_rope as ref_rope
    from repro_torch.models.layers import apply_mrope, apply_rope

    x = _x((2, 9, 3, 16), seed=2)
    pos = np.random.default_rng(3).integers(0, 600, (2, 9)).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    assert _rel(got, ref_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
                ) < F32_TOL
    pos3 = np.random.default_rng(4).integers(0, 600, (2, 9, 3)).astype(
        np.int32)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                      (2, 3, 3))
    want = ref_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (2, 3, 3))
    assert _rel(got, want) < F32_TOL
    # halves, not interleaved pairs: slot i pairs with slot i + D/2
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    rot = apply_rope(torch.from_numpy(one), torch.tensor([[1]]), 10_000.0)
    assert rot[0, 0, 0, 8].item() == pytest.approx(np.sin(1.0), abs=1e-6)


# ---------------------------------------------------------- attention ----
FLASH_CASES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "windowed": dict(causal=True, window=8),
    "skip_masked_blocks": dict(causal=True, skip_masked_blocks=True),
    "ragged_chunks": dict(causal=True, S=45, q_chunk=16, kv_chunk=16),
    "kv_valid": dict(causal=True, valid="random"),
    "wholly_masked_chunk": dict(causal=True, valid="first_chunk_empty"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    import jax.numpy as jnp

    from repro.models.attention import flash_attention as ref_flash
    from repro_torch.models.attention import flash_attention

    kw = dict(FLASH_CASES[case])
    S = kw.pop("S", 48)
    valid = kw.pop("valid", None)
    kw.setdefault("q_chunk", 16)
    kw.setdefault("kv_chunk", 16)
    B, Hq, Hkv, D = 2, 4, 2, 16
    q, k, v = (_x((B, S, h, D), seed=s) for s, h in
               ((5, Hq), (6, Hkv), (7, Hkv)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kv_valid = None
    if valid == "random":
        kv_valid = np.random.default_rng(8).random((B, S)) < 0.7
        kv_valid[:, 0] = True  # every query keeps a key
    elif valid == "first_chunk_empty":
        # empty cache slots (pos = -1) filling the first KV chunk: its
        # scores are all NEG_INF; -inf there would give NaN
        kv_valid = np.ones((B, S), bool)
        kv_valid[:, :16] = False
        q_pos = pos + 16
        kw["causal"] = True
    q_pos = pos if valid != "first_chunk_empty" else q_pos
    t = {n: torch.from_numpy(a) for n, a in
         dict(q=q, k=k, v=v, qp=q_pos, kp=pos).items()}
    got = flash_attention(
        t["q"], t["k"], t["v"], t["qp"], t["kp"],
        kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid),
        **kw)
    want = ref_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(pos),
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid), **kw)
    assert got.shape == (B, S, Hq, D)
    assert torch.isfinite(got).all()
    assert _rel(got, want) < F32_TOL


def test_flash_attention_chunking_is_exact():
    """Chunk sizes change the summation order only: one chunk, ragged
    chunks and block skipping agree on the same inputs."""
    from repro_torch.models.attention import flash_attention

    B, S, H, D = 1, 40, 2, 8
    q, k, v = (torch.from_numpy(_x((B, S, H, D), seed=s)) for s in (9, 10, 11))
    pos = torch.arange(S, dtype=torch.int32)[None]
    one = flash_attention(q, k, v, pos, pos, q_chunk=S, kv_chunk=S)
    for qc, kc, skip in ((7, 9, False), (16, 16, True), (1, 40, True)):
        got = flash_attention(q, k, v, pos, pos, q_chunk=qc, kv_chunk=kc,
                              skip_masked_blocks=skip)
        assert _rel(got, one.numpy()) < F32_TOL


# ------------------------------------------------------------- RG-LRU ----
def test_lru_scan_matches_reference_and_recurrence():
    import jax.numpy as jnp

    from repro.models.rglru import _lru_scan as ref_scan
    from repro_torch.models.rglru import _lru_scan

    B, S, W = 2, 37, 8
    rng = np.random.default_rng(12)
    a = rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    u = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    got = _lru_scan(torch.from_numpy(a), torch.from_numpy(u),
                    torch.from_numpy(h0))
    assert _rel(got, ref_scan(jnp.asarray(a), jnp.asarray(u),
                              jnp.asarray(h0))) < F32_TOL
    h, seq = h0.astype(np.float64), []
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        seq.append(h)
    assert _rel(got, np.stack(seq, 1)) < F32_TOL


@pytest.mark.parametrize("S", [1, 11])
def test_rglru_block_with_state_matches_reference(S):
    import jax.numpy as jnp

    from repro.models.rglru import rglru_block
    from repro_torch.models.rglru import RGLRU

    cfg, rcfg, state = _layer("recurrentgemma-2b", "inner")
    m = _port(RGLRU(cfg, _init()), state, torch.float32)
    B, W = 2, cfg.lru_width
    x = _x((B, S, cfg.d_model), seed=13)
    h0 = _x((B, W), seed=14)
    conv0 = _x((B, cfg.conv_width - 1, W), seed=15)
    st = {"h": torch.from_numpy(h0.copy()),
          "conv": torch.from_numpy(conv0.copy())}
    y = m(torch.from_numpy(x), st)
    want, new = rglru_block(_ref(state, jnp.float32), rcfg, jnp.asarray(x),
                            {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)})
    assert _rel(y, want) < F32_TOL
    assert _rel(st["h"], new["h"]) < F32_TOL
    assert _rel(st["conv"], new["conv"]) < F32_TOL
    # no state: fresh zeros, nothing kept
    y0 = m(torch.from_numpy(x))
    want0, none = rglru_block(_ref(state, jnp.float32), rcfg, jnp.asarray(x))
    assert none is None and _rel(y0, want0) < F32_TOL


# ------------------------------------------------------------- RWKV-6 ----
@pytest.mark.parametrize("S,chunk", [(40, 16), (64, 64), (1, 64)])
def test_wkv_chunked_matches_reference(S, chunk):
    import jax.numpy as jnp

    from repro.models.rwkv6 import _wkv_chunked as ref_wkv
    from repro_torch.models.rwkv6 import _wkv_chunked

    B, H, D = 2, 3, 8
    rng = np.random.default_rng(16)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.6, 0.999, (B, S, H, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.3
    S0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    out, fin = _wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, w)),
                            torch.from_numpy(u), chunk, torch.from_numpy(S0))
    want, want_fin = ref_wkv(*(jnp.asarray(a) for a in (r, k, v, w)),
                             jnp.asarray(u), chunk, jnp.asarray(S0))
    assert _rel(out, want) < F32_TOL and _rel(fin, want_fin) < F32_TOL


@pytest.mark.parametrize("S", [1, 24])
def test_rwkv6_blocks_with_state_match_reference(S):
    import jax.numpy as jnp

    from repro.models.rwkv6 import rwkv6_block, rwkv6_channel_mix
    from repro_torch.models.rwkv6 import RWKV6

    cfg, rcfg, state = _layer("rwkv6-1.6b", "inner")
    m = _port(RWKV6(cfg, _init()), state, torch.float32)
    B, d, hd = 2, cfg.d_model, cfg.rwkv_head_dim
    x = _x((B, S, d), seed=17)
    x2 = _x((B, S, d), seed=18)
    st0 = {"S": _x((B, d // hd, hd, hd), seed=19, scale=0.1),
           "shift_tm": _x((B, d), seed=20), "shift_cm": _x((B, d), seed=21)}
    st = {n: torch.from_numpy(a.copy()) for n, a in st0.items()}
    p = _ref(state, jnp.float32)
    y = m(torch.from_numpy(x), st)
    want, new = rwkv6_block(p, rcfg, jnp.asarray(x),
                            {n: jnp.asarray(a) for n, a in st0.items()})
    assert _rel(y, want) < F32_TOL
    for n in ("S", "shift_tm", "shift_cm"):
        assert _rel(st[n], new[n]) < F32_TOL, n
    c = m.channel_mix(torch.from_numpy(x2), st)
    want_c, new_c = rwkv6_channel_mix(p, rcfg, jnp.asarray(x2), new)
    assert _rel(c, want_c) < F32_TOL
    for n in ("S", "shift_tm", "shift_cm"):
        assert _rel(st[n], new_c[n]) < F32_TOL, n
