"""The MoE layer and MLA attention against the reference's on identical
inputs: ``moe_block`` with GShard and sort dispatch, with and without
shared experts, at an ample capacity and at ``capacity_factor=0.5`` (some
(token, choice) entries dropped), its auxiliary loss; one expert against
the dense SwiGLU; ``flash_attention``'s ``scale`` with D != Dv and one KV
head; the MLA block uncached (expanded K/V) and cached (prefill, then two
decode steps: the compressed cache and the absorbed queries); within the
port, cached decode against the uncached forward on an MLA config without
experts; the smoke models' ``forward(with_aux=True)`` under both
dispatches.

Weights: ``repro_torch.interop.random_lm_state`` (seeded numpy) of the
deepseek-v2 smoke config (a layer's slice of it), inputs seeded numpy;
both packages get the identical values. Tolerances (max over elements,
over the reference's largest entry), f32: y within 1e-5, the aux loss
within 1e-6, the MLA block's outputs and cache within 1e-6, absorbed
against expanded within 1e-5. The ``cuda`` case needs a card and imports
no JAX: both dispatches and the MLA block on the card against the port on
the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

Y_TOL = 1e-5
AUX_TOL = 1e-6
MLA_TOL = 1e-6
ABSORB_TOL = 1e-5
ARCH = "deepseek-v2-236b"
B, S = 2, 16
# the reference's FAMS["mla"]: MLA with a query rank and no experts
MLA_DENSE = dict(name="mla", family="moe", num_layers=2, d_model=32, d_ff=64,
                 vocab_size=31, num_heads=2, attn_kind="mla", q_lora_rank=16,
                 kv_lora_rank=8, qk_nope_head_dim=8, qk_rope_head_dim=4,
                 v_head_dim=8, dtype="float32", param_dtype="float32")


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


def _layer(prefix, layer, **changes):
    """(port config, reference config, numpy weights under ``prefix`` of
    layer ``layer`` of the deepseek-v2 smoke config with ``changes``)."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import random_lm_state

    cfg = dataclasses.replace(get_smoke_config(ARCH), **changes)
    rcfg = dataclasses.replace(ref_smoke(ARCH), **changes)
    full = f"blocks.{layer}.{prefix}."
    state = {k[len(full):]: v for k, v in random_lm_state(cfg).items()
             if k.startswith(full)}
    assert state
    return cfg, rcfg, state


def _init():
    from repro_torch.models.layers import Init

    return Init(torch.device("cpu"), torch.float32,
                torch.Generator().manual_seed(0))


def _load(module, state):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return module


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _dropped(moe, x):
    """(token, choice) entries past their expert's capacity, over the
    batch rows."""
    from repro_torch.models.moe import moe_capacity

    cfg = moe.cfg
    idx = torch.topk(x.float() @ moe.router, cfg.top_k, dim=-1).indices
    counts = torch.nn.functional.one_hot(idx, cfg.num_experts).sum((1, 2))
    return int((counts - moe_capacity(cfg, x.shape[1])).clamp_min(0).sum())


# ---------------------------------------------------------------- MoE ----
@pytest.mark.parametrize("impl", ["gshard", "sort"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("factor", [4.0, 0.5])  # E / k: nothing drops
def test_moe_block_matches_reference(impl, shared, factor):
    import jax.numpy as jnp

    from repro.models.moe import moe_block
    from repro_torch.models.moe import MoE

    cfg, rcfg, state = _layer("mlp", 1, moe_impl=impl,
                              num_shared_experts=shared,
                              capacity_factor=factor)
    assert cfg.num_experts / cfg.top_k == 4.0
    assert ("shared.wi.w" in state) == bool(shared)
    moe = _load(MoE(cfg, _init()), state)
    assert moe.router.dtype == torch.float32
    x = _x((B, S, cfg.d_model), seed=1)
    y, aux = moe(torch.from_numpy(x))
    want, want_aux = moe_block(_nest({k: jnp.asarray(v)
                                      for k, v in state.items()}),
                               rcfg, jnp.asarray(x))
    drops = _dropped(moe, torch.from_numpy(x))
    assert (drops > 0) == (factor < 1.0), drops
    assert y.shape == x.shape and aux.dtype == torch.float32
    assert _rel(y, want) < Y_TOL
    assert abs(aux.item() - float(want_aux)) < AUX_TOL * abs(float(want_aux))


@pytest.mark.parametrize("impl", ["gshard", "sort"])
def test_moe_single_expert_equals_dense_swiglu(impl):
    """One expert, top-1, ample capacity: the gate is 1 and the layer is
    its expert's SwiGLU (the reference's own test, on the port)."""
    from repro_torch.models.layers import MLP
    from repro_torch.models.moe import MoE

    cfg, _, _ = _layer("mlp", 1, num_experts=1, top_k=1,
                       num_shared_experts=0, capacity_factor=4.0,
                       moe_impl=impl)
    moe = MoE(cfg, _init())
    mlp = MLP(cfg.d_model, cfg.moe_d_ff, "swiglu", _init())
    for name in ("wi", "wg", "wo"):
        getattr(mlp, name).w.copy_(getattr(moe, name)[0])
    x = torch.from_numpy(_x((B, 8, cfg.d_model), seed=2))
    y, aux = moe(x)
    assert _rel(y, mlp(x).numpy()) < Y_TOL
    assert torch.isfinite(aux)


def test_sort_keeps_the_gshard_entries():
    """At a tight capacity both dispatches drop by queue position in token
    order (the sort is stable): the same entries survive, so the outputs
    agree."""
    from repro_torch.models.moe import MoE

    cfg, _, state = _layer("mlp", 1, capacity_factor=0.5)
    x = torch.from_numpy(_x((B, S, cfg.d_model), seed=3))
    g = _load(MoE(cfg, _init()), state)
    s = _load(MoE(dataclasses.replace(cfg, moe_impl="sort"), _init()), state)
    assert _dropped(g, x) > 0
    assert _rel(s(x)[0], g(x)[0].numpy()) < Y_TOL


# ---------------------------------------------------------- attention ----
@pytest.mark.parametrize("cached", [False, True])
def test_flash_attention_scale_matches_reference(cached):
    """MLA's absorbed shapes: D = rank + dr, Dv = rank, one KV head shared
    by every query head, the scale 1/sqrt(dn + dr) (dn + dr = 12 here, not
    D); the cached case with empty slots."""
    import jax.numpy as jnp

    from repro.models.attention import flash_attention as ref_flash
    from repro_torch.models.attention import flash_attention

    Sq, Skv, H, D, Dv = (1, 24, 4, 24, 16) if cached else (24, 24, 4, 24, 16)
    q, k = _x((B, Sq, H, D), 4), _x((B, Skv, 1, D), 5)
    v = _x((B, Skv, 1, Dv), 6)
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    q_pos = kv_pos[:, Skv - Sq:].copy()
    kw = dict(q_chunk=8, kv_chunk=8, scale=1.0 / np.sqrt(12.0))
    valid = None
    if cached:
        kv_pos[:, 20:] = -1  # empty slots
        q_pos[:] = 19
        valid = kv_pos >= 0
    got = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
        kv_valid=None if valid is None else torch.from_numpy(valid), **kw)
    want = ref_flash(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
                     kv_valid=None if valid is None else jnp.asarray(valid),
                     **kw)
    assert got.shape == (B, Sq, H, Dv)
    assert _rel(got, want) < Y_TOL
    default = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
        kv_valid=None if valid is None else torch.from_numpy(valid),
        q_chunk=8, kv_chunk=8)
    assert _rel(default, want) > 1e-3  # 1/sqrt(D) is another attention


def test_mla_block_matches_reference():
    """Uncached (K and V expanded per head), then a cache: an 8-token
    prefill and two decode steps through the absorbed path; the outputs
    and the cache's ``ckv``, ``krope`` and ``pos`` against the
    reference's."""
    import jax
    import jax.numpy as jnp

    from repro.models.attention import attention_block
    from repro.models.attention import init_kv_cache as ref_init_kv_cache
    from repro_torch.models.attention import MLAttention, init_kv_cache

    cfg, rcfg, state = _layer("inner", 0)
    attn = _load(MLAttention(cfg, _init()), state)
    params = _nest({k: jnp.asarray(v) for k, v in state.items()})
    P, T = 8, 2
    x = _x((B, P + T, cfg.d_model), seed=7)
    pos = np.broadcast_to(np.arange(P + T, dtype=np.int32), (B, P + T)).copy()

    def ref(xs, ps, cache, index):
        return jax.jit(lambda p, a, b, c, i: attention_block(
            p, rcfg, a, b, c, i, q_chunk=4, kv_chunk=4))(
                params, jnp.asarray(xs), jnp.asarray(ps), cache,
                None if cache is None else jnp.asarray(index, jnp.int32))

    got = attn(torch.from_numpy(x[:, :P]), torch.from_numpy(pos[:, :P]),
               q_chunk=4, kv_chunk=4)
    want, _ = ref(x[:, :P], pos[:, :P], None, 0)
    assert _rel(got, want) < MLA_TOL

    cache = init_kv_cache(cfg, B, P + T, torch.float32, "cpu")
    rcache = ref_init_kv_cache(rcfg, B, P + T, jnp.float32)
    assert sorted(cache) == sorted(rcache) == ["ckv", "krope", "pos"]
    for lo, hi in ((0, P), (P, P + 1), (P + 1, P + 2)):
        got = attn(torch.from_numpy(x[:, lo:hi]),
                   torch.from_numpy(pos[:, lo:hi]), cache, lo, q_chunk=4,
                   kv_chunk=4)
        want, rcache = ref(x[:, lo:hi], pos[:, lo:hi], rcache, lo)
        assert _rel(got, want) < MLA_TOL, lo
    for name, val in rcache.items():
        assert tuple(cache[name].shape) == val.shape, name
        if name == "pos":
            np.testing.assert_array_equal(cache[name].numpy(), val)
        else:
            assert _rel(cache[name], val) < MLA_TOL, name


def test_mla_absorbed_decode_equals_expanded_forward():
    """Within the port, on an MLA config without experts: the prefill of
    S - 1 tokens and one decode step through the compressed cache give
    the uncached forward's logits."""
    from repro_torch.interop import random_lm_state
    from repro_torch.models import (LanguageModel, ModelConfig, forward,
                                    init_cache)

    cfg = ModelConfig(**MLA_DENSE)
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_lm_state(cfg, seed=4).items()})
    n = 12
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32))
    with torch.inference_mode():
        full, _ = forward(model, {"tokens": toks})
        cache = init_cache(cfg, B, 16, "cpu")
        pre, cache = forward(model, {"tokens": toks[:, :-1]}, cache)
        dec, _ = forward(model, {"tokens": toks[:, -1:]}, cache, n - 1)
    assert _rel(pre, full[:, :-1].numpy()) < ABSORB_TOL
    assert _rel(dec[:, 0], full[:, -1].numpy()) < ABSORB_TOL


# ------------------------------------------------------------- models ----
@pytest.mark.parametrize("arch,impl", [("deepseek-v2-236b", "gshard"),
                                       ("deepseek-v2-236b", "sort"),
                                       ("grok-1-314b", "sort")])
def test_forward_with_aux_matches_reference(arch, impl):
    """``forward(with_aux=True)``: the reference's (logits, cache, aux),
    the aux summed over the MoE layers (deepseek's layer 0 is dense)."""
    import pathlib
    import sys

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import forward as ref_forward
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import (lm_params_from_reference,
                                     random_lm_state)
    from repro_torch.models import LanguageModel, forward
    from repro_torch.models.moe import MoE

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_lm_golden as golden

    cfg = dataclasses.replace(get_smoke_config(arch), moe_impl=impl)
    rcfg = dataclasses.replace(ref_smoke(arch), moe_impl=impl)
    params = golden.reference_params(rcfg, random_lm_state(cfg))
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    assert [isinstance(b.mlp, MoE) for b in model.blocks] == [
        li >= cfg.first_dense_layers for li in range(cfg.num_layers)]
    toks = golden.prompt(cfg, seed=3, length=S)
    logits, cache, aux = forward(model, {"tokens": torch.from_numpy(toks)},
                                 with_aux=True)
    want, _, want_aux = jax.jit(lambda p, t: ref_forward(
        p, rcfg, {"tokens": t}))(params, jnp.asarray(toks))
    assert cache is None
    assert _rel(logits, want) < Y_TOL
    assert abs(aux.item() - float(want_aux)) < AUX_TOL * float(want_aux)
    assert len(forward(model, {"tokens": torch.from_numpy(toks)})) == 2


# --------------------------------------------------------------- card ----
@pytest.mark.cuda
def test_moe_and_mla_on_cuda():
    """Both dispatches (GShard and sort, with drops) and the MLA block
    (uncached, then prefill and a decode step) on the card against the
    port on the CPU, TF32 off, bar 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import random_lm_state
    from repro_torch.models.attention import MLAttention, init_kv_cache
    from repro_torch.models.layers import Init
    from repro_torch.models.moe import MoE

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = dataclasses.replace(get_smoke_config(ARCH),
                                   capacity_factor=0.5)
        state = random_lm_state(base)

        def build(cls, cfg, prefix, device):
            init = Init(torch.device(device), torch.float32,
                        torch.Generator(device=device).manual_seed(0))
            full = f"blocks.{prefix}."
            return _load(cls(cfg, init), {
                k[len(full):]: v for k, v in state.items()
                if k.startswith(full)}).to(device)

        x = torch.from_numpy(_x((B, S, base.d_model), seed=8))
        for impl in ("gshard", "sort"):
            cfg = dataclasses.replace(base, moe_impl=impl)
            cpu = build(MoE, cfg, "1.mlp", "cpu")
            assert _dropped(cpu, x) > 0
            gpu = build(MoE, cfg, "1.mlp", "cuda")
            (y, aux), (yc, auxc) = gpu(x.cuda()), cpu(x)
            assert _rel(y.cpu(), yc.numpy()) < 1e-4, impl
            assert abs(aux.item() - auxc.item()) < 1e-4 * auxc.item(), impl
        cpu = build(MLAttention, base, "0.inner", "cpu")
        gpu = build(MLAttention, base, "0.inner", "cuda")
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        assert _rel(gpu(x.cuda(), pos.cuda()).cpu(), cpu(x, pos).numpy()
                    ) < 1e-4
        caches = {d: init_kv_cache(base, B, S, torch.float32, d)
                  for d in ("cpu", "cuda")}
        for lo, hi in ((0, S - 1), (S - 1, S)):
            want = cpu(x[:, lo:hi], pos[:, lo:hi], caches["cpu"], lo)
            got = gpu(x[:, lo:hi].cuda(), pos[:, lo:hi].cuda(),
                      caches["cuda"], lo)
            assert _rel(got.cpu(), want.numpy()) < 1e-4, lo
        for name in ("ckv", "krope"):
            assert _rel(caches["cuda"][name].cpu(),
                        caches["cpu"][name].numpy()) < 1e-4, name
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
