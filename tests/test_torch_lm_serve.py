"""The LM serving path against the reference, one parametrized case per
smoke config (all ten, deepseek-v2's MLA and MoE and grok-1's MoE among
them): the configs are the reference's field for field; ``forward``
logits; prefill then decode, logits and cache contents (MLA's compressed
``ckv`` / ``krope`` too); ``greedy_generate``'s tokens, equal at f32; a
ring-buffer decode past the window (recurrentgemma); qwen1.5's float8
cache; the frontend stubs; the golden file (recomputed with the reference,
and met by the port); the serving launcher.

Weights: ``repro_torch.interop.random_lm_state`` (seeded numpy), rounded
to each package's param dtype, carried into the port by
``lm_params_from_reference``; prompts: seeded numpy. Tolerances (max
relative: over elements, over the reference's largest entry), measured
here: f32 logits and caches within 1e-6 of the reference's (worst
9.99e-7, rwkv6's decode caches), bar 1e-5; the float8 cache equal; bf16
logits within 1.2e-2 relative L2 (rwkv6 1.11e-2), bar 2e-2. The golden
file is recomputed bit for bit (bar 1e-6).
The ``cuda`` case needs a card and imports no JAX."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_lm_golden as golden  # noqa: E402

pytestmark = pytest.mark.torch_port

F32_TOL = 1e-5
BF16_L2_TOL = 2e-2
ARCHS = golden.ARCHS
DECODERS = tuple(a for a in ARCHS if a != "hubert-xlarge")
_REF: dict = {}


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rel_l2(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _reference(arch):
    """The reference's golden outputs of ``arch`` with its final cache,
    computed once per worker."""
    if arch not in _REF:
        _REF[arch] = golden.reference_outputs(arch, keep_cache=True)
    return _REF[arch]


def _configs(arch, **changes):
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config

    return (dataclasses.replace(get_smoke_config(arch), **changes),
            dataclasses.replace(ref_smoke(arch), **changes))


def _models(arch, **changes):
    """(port model, reference params, port config, reference config) on
    the identical seeded weights, carried through
    ``lm_params_from_reference``."""
    import jax

    from repro_torch.interop import lm_params_from_reference, random_lm_state
    from repro_torch.models import LanguageModel

    cfg, rcfg = _configs(arch, **changes)
    params = golden.reference_params(rcfg, random_lm_state(cfg))
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    return model, params, cfg, rcfg


def _check_cache(cfg, port_cache, ref_cache, tol=F32_TOL):
    from repro_torch.interop import lm_layers_from_reference

    ref_layers = lm_layers_from_reference(cfg, ref_cache)
    assert len(port_cache) == len(ref_layers) == cfg.num_layers
    for li, (got, want) in enumerate(zip(port_cache, ref_layers)):
        assert sorted(got) == sorted(want), li
        for name, val in want.items():
            g = got[name]
            assert tuple(g.shape) == val.shape, (li, name)
            if name == "pos":
                np.testing.assert_array_equal(g.numpy(), val)
            else:
                assert _rel(g, np.asarray(val, np.float32)) < tol, (li, name)


# ----------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_s(arch):
    from repro.configs import get_config as ref_full
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_config, get_smoke_config, list_archs

    assert arch in list_archs()
    for port, ref in ((get_config(arch), ref_full(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.layer_kinds == ref.layer_kinds


def test_reference_params_carry_bit_for_bit():
    """The reference's own bf16 init (``ml_dtypes.bfloat16`` leaves as
    numpy) loads strictly into the port, every bit kept."""
    import jax

    from repro.models import init_model
    from repro_torch.interop import lm_params_from_reference
    from repro_torch.models import LanguageModel

    # 7 layers: two cycles of (rglru, rglru, attn), then an epilogue
    cfg, rcfg = _configs("recurrentgemma-2b", dtype="bfloat16",
                         param_dtype="bfloat16", num_layers=7)
    params = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(3), rcfg))
    state = lm_params_from_reference(cfg, params)
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(state)  # strict: the names and shapes are all
    got = model.state_dict()
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].view(torch.int16).numpy(),
                                  params["embed"].view(np.int16))
    # layer 4 is body[1] of cycle 1 (pattern rglru, rglru, attn)
    body = params["stack"]["body"][1]["inner"]["wa"]["w"][1]
    np.testing.assert_array_equal(
        got["blocks.4.inner.wa.w"].view(torch.int16).numpy(),
        body.view(np.int16))
    epi = params["stack"]["epilogue"][0]["inner"]["lam"]
    np.testing.assert_array_equal(
        got["blocks.6.inner.lam"].view(torch.int16).numpy(),
        epi.view(np.int16))


# ----------------------------------------------------------- serving ----
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    from repro_torch.models import forward

    model, _, _, _ = _models(arch)
    ref = _reference(arch)
    logits, cache = forward(model, {"tokens": torch.from_numpy(ref["prompt"])})
    assert cache is None
    assert _rel(logits, ref["forward"]) < F32_TOL


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_matches_reference(arch):
    """Logits of the prefill and of each decode step, then every layer's
    cache (K/V and slot positions, RG-LRU's (h, conv), RWKV's
    (S, shift_tm, shift_cm))."""
    from repro_torch.models import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    model, _, cfg, _ = _models(arch)
    ref = _reference(arch)
    cache = init_cache(cfg, golden.BATCH, golden.PROMPT + golden.DECODE,
                       "cpu")
    logits, out = make_prefill_step(model)(
        {"tokens": torch.from_numpy(ref["prompt"])}, cache)
    assert out is cache  # updated in place
    assert _rel(logits, ref["prefill"]) < F32_TOL
    decode = make_decode_step(model)
    for t in range(golden.DECODE):
        tok = torch.from_numpy(ref["tokens"][:, t:t + 1].copy())
        logits, cache = decode(tok, cache, golden.PROMPT + t)
        assert _rel(logits, ref["decode"][:, t]) < F32_TOL, t
    _check_cache(cfg, cache, ref["cache"])


@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_tokens_equal_reference(arch):
    from repro_torch.train import greedy_generate

    model, _, _, _ = _models(arch)
    ref = _reference(arch)
    toks, logits = greedy_generate(model, torch.from_numpy(ref["prompt"]),
                                   golden.DECODE + 1, all_logits=True)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])
    assert _rel(logits[:, 1:], ref["decode"]) < F32_TOL


def test_greedy_generate_is_the_reference_s():
    """The reference's own ``greedy_generate`` loop, steps and last
    logits included."""
    import jax.numpy as jnp

    from repro.train.serve_step import greedy_generate as ref_greedy
    from repro_torch.train import greedy_generate

    model, params, _, rcfg = _models("qwen2-vl-2b")
    prompt = golden.prompt(rcfg, seed=5, length=11)
    want, want_logits = ref_greedy(params, rcfg, jnp.asarray(prompt), 6)
    got, logits = greedy_generate(model, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _rel(logits, want_logits) < F32_TOL


def test_ring_buffer_decode_past_the_window():
    """recurrentgemma's local attention (window 16): a 20-token prompt
    prefills in context and keeps its last 16 tokens; 14 decode steps wrap
    the ring."""
    import jax
    import jax.numpy as jnp

    from repro.models import init_cache as ref_init_cache
    from repro.train import make_decode_step as ref_decode_step
    from repro.train import make_prefill_step as ref_prefill_step
    from repro_torch.models import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    model, params, cfg, rcfg = _models("recurrentgemma-2b")
    assert cfg.local_window == 16
    S, steps, B = 20, 14, 2
    prompt = golden.prompt(cfg, seed=7, length=S)
    cache = init_cache(cfg, B, S + steps, "cpu")
    rcache = ref_init_cache(rcfg, B, S + steps)
    assert cache[2]["k"].shape[1] == 16  # the ring: the window's slots
    logits, cache = make_prefill_step(model)(
        {"tokens": torch.from_numpy(prompt)}, cache)
    rlogits, rcache = jax.jit(ref_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(prompt)}, rcache)
    assert _rel(logits, rlogits) < F32_TOL
    np.testing.assert_array_equal(np.sort(cache[2]["pos"].numpy()[0]),
                                  np.arange(S - 16, S))
    decode, rdecode = make_decode_step(model), jax.jit(ref_decode_step(rcfg))
    for t in range(steps):
        tok = rlogits.argmax(-1)[:, None].astype(jnp.int32)
        logits, cache = decode(torch.from_numpy(np.array(tok)), cache, S + t)
        rlogits, rcache = rdecode(params, tok, rcache,
                                  jnp.asarray(S + t, jnp.int32))
        assert _rel(logits, rlogits) < F32_TOL, t
    _check_cache(cfg, cache, jax.tree.map(np.asarray, rcache))
    assert cache[2]["pos"].max().item() == S + steps - 1


def test_float8_cache_matches_reference():
    """qwen1.5-32b's float8_e4m3fn KV cache on its smoke config: K/V round
    on write and read back at f32, in both packages alike."""
    import jax
    import jax.numpy as jnp

    from repro.models import init_cache as ref_init_cache
    from repro.train import make_decode_step as ref_decode_step
    from repro.train import make_prefill_step as ref_prefill_step
    from repro_torch.models import init_cache
    from repro_torch.train import make_decode_step, make_prefill_step

    model, params, cfg, rcfg = _models("qwen1.5-32b",
                                       cache_dtype="float8_e4m3fn")
    S, steps, B = 8, 4, 2
    prompt = golden.prompt(cfg, seed=9, length=S)
    cache = init_cache(cfg, B, S + steps, "cpu")
    assert cache[0]["k"].dtype == torch.float8_e4m3fn
    rcache = ref_init_cache(rcfg, B, S + steps)
    logits, cache = make_prefill_step(model)(
        {"tokens": torch.from_numpy(prompt)}, cache)
    rlogits, rcache = jax.jit(ref_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(prompt)}, rcache)
    assert _rel(logits, rlogits) < F32_TOL
    decode, rdecode = make_decode_step(model), jax.jit(ref_decode_step(rcfg))
    for t in range(steps):
        tok = rlogits.argmax(-1)[:, None].astype(jnp.int32)
        logits, cache = decode(torch.from_numpy(np.array(tok)), cache, S + t)
        rlogits, rcache = rdecode(params, tok, rcache,
                                  jnp.asarray(S + t, jnp.int32))
        assert _rel(logits, rlogits) < F32_TOL, t
    rc = jax.tree.map(np.asarray, rcache)
    for li, layer in enumerate(cache):
        for name in ("k", "v"):
            want = rc["body"][0][name][li].astype(np.float32)
            np.testing.assert_array_equal(layer[name].float().numpy(), want)


@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-2b",
                                  "rwkv6-1.6b", "nemotron-4-340b"])
def test_bf16_forward_near_reference(arch):
    """At bf16 the two packages round their elementwise chains in other
    places; the logits stay within BF16_L2_TOL."""
    import jax.numpy as jnp

    from repro.models import forward as ref_forward
    from repro_torch.models import forward

    model, params, cfg, rcfg = _models(arch, dtype="bfloat16",
                                       param_dtype="bfloat16")
    prompt = golden.prompt(cfg)
    logits, _ = forward(model, {"tokens": torch.from_numpy(prompt)})
    want, _, _ = ref_forward(params, rcfg, {"tokens": jnp.asarray(prompt)})
    assert logits.dtype == torch.bfloat16
    assert _rel_l2(logits, np.asarray(want, np.float32)) < BF16_L2_TOL


@pytest.mark.parametrize("arch,key", [("hubert-xlarge", "features"),
                                      ("qwen2-vl-2b", "vision_embeds")])
def test_frontend_stubs_match_reference(arch, key):
    """Precomputed frame (audio) or patch (VLM) embeddings in the batch;
    the VLM with explicit (t, h, w) M-RoPE positions."""
    import jax.numpy as jnp

    from repro.models import forward as ref_forward
    from repro_torch.models import forward

    model, params, cfg, rcfg = _models(arch)
    B, S = 2, 8
    rng = np.random.default_rng(11)
    batch = {"tokens": golden.prompt(cfg, length=S),
             key: rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    if key == "vision_embeds":
        batch["vision_mask"] = rng.random((B, S)) < 0.5
        batch["positions"] = rng.integers(0, 9, (B, S, 3)).astype(np.int32)
    logits, _ = forward(model, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    want, _, _ = ref_forward(params, rcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    assert _rel(logits, want) < F32_TOL


# ------------------------------------------------------------ golden ----
@pytest.mark.parametrize("arch", ARCHS)
def test_golden_file_is_the_reference_s(arch):
    """The stored logits are what the reference computes now."""
    stored = golden.load()
    ref = _reference(arch)
    keys = sorted(k.split("/")[1] for k in stored if k.startswith(arch + "/"))
    assert keys == sorted(k for k in ref if k != "cache")
    for k in keys:
        if k in ("prompt", "tokens"):
            np.testing.assert_array_equal(stored[f"{arch}/{k}"], ref[k])
        else:
            assert _rel(stored[f"{arch}/{k}"], ref[k]) < 1e-6, k


def _port_meets_golden(device):
    """Every arch of the golden file through the port on ``device`` (f32,
    seeded numpy weights): {arch: worst max-relative distance}; the greedy
    tokens must be equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import random_lm_state
    from repro_torch.models import LanguageModel, forward
    from repro_torch.train import greedy_generate

    stored = golden.load()
    worst = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        model = LanguageModel(cfg, device=device)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               random_lm_state(cfg).items()})
        prompt = torch.from_numpy(stored[f"{arch}/prompt"]).to(device)
        with torch.inference_mode():
            errs = [_rel(forward(model, {"tokens": prompt})[0].cpu(),
                         stored[f"{arch}/forward"])]
        if f"{arch}/decode" in stored:
            toks, logits = greedy_generate(model, prompt, golden.DECODE + 1,
                                           all_logits=True)
            np.testing.assert_array_equal(toks.cpu().numpy(),
                                          stored[f"{arch}/tokens"])
            errs += [_rel(logits[:, 0].cpu(), stored[f"{arch}/prefill"]),
                     _rel(logits[:, 1:].cpu(), stored[f"{arch}/decode"])]
        worst[arch] = max(errs)
    return worst


def test_port_meets_golden_on_cpu():
    worst = _port_meets_golden("cpu")
    assert max(worst.values()) < F32_TOL, worst


@pytest.mark.cuda
def test_port_meets_golden_on_cuda():
    """The golden smoke logits on the card (TF32 off), bar 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = _port_meets_golden("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert max(worst.values()) < 1e-4, worst


# ---------------------------------------------------------- launcher ----
@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-2b",
                                  "rwkv6-1.6b", "deepseek-v2-236b"])
def test_serve_launcher_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "20", "--steps", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "prefill 20 toks" in out and "decode  4 steps" in out
    assert "tok/s" in out and "peak device bytes: not measured (cpu)" in out


def test_serve_launcher_refuses_encoder_only_and_feti():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="encoder-only: no decode path"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not a language model"):
        serve.main(["--arch", "feti-heat-2d", "--smoke", "--device", "cpu"])
