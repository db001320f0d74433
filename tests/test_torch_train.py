"""The LM training path against the reference: the cosine schedule, one
AdamW update (f32 and bf16 moments) and its slicing, ``loss_fn`` and its
parts, three ``make_train_step`` steps (from the start, and from a state
carried mid-training through ``train_state_from_reference``), the loss
going down on a learnable stream, and the golden file (recomputed with
the reference, and met by the port). Gradient accumulation, ``remat``,
the sort dispatch's backward and the launcher are in
``test_torch_train_accum.py`` (the reference's compiles split over two
files).

Families: dense (granite-3-8b), MoE (grok-1-314b), MLA + MoE
(deepseek-v2-236b), RWKV-6 (rwkv6-1.6b), RG-LRU (recurrentgemma-2b), on
their smoke configs at f32 with the seeded numpy weights of
``random_lm_state`` and the reference's own ``synthetic_batch`` data,
lr 1e-4 (see ``torch_train_golden``'s note on AdamW near eps).
Tolerances (max relative: over elements, over the reference's largest
entry), measured here: losses and parts within 2.5e-7, gradient norms
within 8e-7, parameters after three steps within 5.7e-6 (deepseek with
grad_accum 4), moments within 2.7e-6; bar 1e-5. One AdamW update on
shared inputs within 1e-6. The golden file is recomputed within 1e-6;
the port meets all its entries within 1.14e-5 (qwen2-vl-2b's ``wq``, an
element whose first clipped gradient sits near eps), bar 1e-4 here and
on the card.
The ``cuda`` case needs a card and imports no JAX."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_train_golden as golden  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-5
GOLDEN_TOL = 1e-4  # the card's bar for the golden file, as the lm phase's
FAMILIES = ("granite-3-8b", "grok-1-314b", "deepseek-v2-236b", "rwkv6-1.6b",
            "recurrentgemma-2b")
_REF: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several workers a machine, whose thread pools would oversubscribe its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch, grad_accum=1, remat=False, **changes):
    return golden.cached_reference(_REF, arch, grad_accum, remat, **changes)


# --------------------------------------------------------- optimizer ----
def test_cosine_lr_matches_reference():
    import jax.numpy as jnp

    from repro.train import OptimizerConfig as RefConfig
    from repro.train.optimizer import cosine_lr as ref_lr
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.optimizer import cosine_lr

    fields = dict(learning_rate=1.0, warmup_steps=10, total_steps=100,
                  min_lr_ratio=0.1)
    cfg, rcfg = OptimizerConfig(**fields), RefConfig(**fields)
    for s in (0, 5, 10, 37, 100, 150):
        got = cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(ref_lr(rcfg, jnp.asarray(s))),
                                           rel=1e-6, abs=1e-7), s
    assert float(cosine_lr(cfg, 0)) == 0.0
    assert float(cosine_lr(cfg, 10)) == pytest.approx(1.0)
    assert float(cosine_lr(cfg, 100)) == pytest.approx(0.1, rel=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """One update on shared parameters (f32 and bf16), gradients and
    nonzero moments, the step past warm-up, a norm above the clip."""
    import jax.numpy as jnp

    from repro.train import OptimizerConfig as RefConfig
    from repro.train import adamw_update as ref_update
    from repro_torch.train import OptimizerConfig, adamw_update

    fields = dict(learning_rate=0.05, warmup_steps=2, total_steps=20,
                  moment_dtype=moments)
    cfg, rcfg = OptimizerConfig(**fields), RefConfig(**fields)
    rng = np.random.default_rng(3)
    shapes = {"w": ((6, 5), jnp.float32), "b": ((7,), jnp.bfloat16)}
    p = {n: jnp.asarray(rng.standard_normal(s), d) for n, (s, d) in
         shapes.items()}
    g = {n: jnp.asarray(rng.standard_normal(s) * 3, d) for n, (s, d) in
         shapes.items()}
    mdt = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    st = {"m": {n: jnp.asarray(rng.standard_normal(s) * 0.1, mdt)
                for n, (s, _) in shapes.items()},
          "v": {n: jnp.asarray(rng.random(s) * 0.1, mdt)
                for n, (s, _) in shapes.items()},
          "step": jnp.asarray(4, jnp.int32)}

    def port(tree):
        return {n: torch.from_numpy(np.array(v, np.float32)).to(
            {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[
                v.dtype.type]) for n, v in tree.items()}

    want_p, want_st, want_m = ref_update(p, g, st, rcfg)
    pp, pst = port(p), {"m": port(st["m"]), "v": port(st["v"]),
                        "step": torch.tensor(4, dtype=torch.int32)}
    got_p, got_st, got_m = adamw_update(pp, port(g), pst, cfg)
    assert got_p is pp and got_st is pst  # in place
    assert int(got_st["step"]) == 5
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=1e-6)
    assert float(got_m["lr"]) == pytest.approx(float(want_m["lr"]), rel=1e-6)
    for n in shapes:
        assert got_p[n].dtype == port(p)[n].dtype
        assert got_st["m"][n].dtype == {
            "float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
        bar = 1e-6 if got_p[n].dtype == torch.float32 else 8e-3
        assert golden.rel(got_p[n], np.asarray(want_p[n], np.float32)) < bar, n
        for k in ("m", "v"):
            bar = 1e-6 if moments == "float32" else 8e-3
            assert golden.rel(got_st[k][n], np.asarray(want_st[k][n],
                                                 np.float32)) < bar, (k, n)


def test_sliced_update_is_the_unsliced_one(monkeypatch):
    """The in-place update in slices of 7 elements is bit-equal to one
    slice a tensor (bf16 parameters, f32 and bf16 moments)."""
    from repro_torch.train import OptimizerConfig, adamw_init, adamw_update
    from repro_torch.train import optimizer

    g = torch.Generator().manual_seed(0)
    for moments in ("float32", "bfloat16"):
        cfg = OptimizerConfig(learning_rate=0.01, warmup_steps=1,
                              moment_dtype=moments)
        shapes = {"a": (3, 50, 4), "b": (101,), "c": (1,)}
        params = {n: torch.randn(s, generator=g).to(torch.bfloat16)
                  for n, s in shapes.items()}
        grads = [{n: torch.randn(s, generator=g).to(torch.bfloat16)
                  for n, s in shapes.items()} for _ in range(3)]
        runs = []
        for max_slice in (7, 1 << 26):
            p = {n: t.clone() for n, t in params.items()}
            st = adamw_init(p, cfg)
            monkeypatch.setattr(optimizer, "MAX_SLICE", max_slice)
            for gr in grads:
                _, st, m = adamw_update(p, gr, st, cfg)
            runs.append((p, st, m))
        (p1, s1, m1), (p2, s2, m2) = runs
        for n in shapes:
            assert torch.equal(p1[n], p2[n])
            assert torch.equal(s1["m"][n], s2["m"][n])
            assert torch.equal(s1["v"][n], s2["v"][n])
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])


# -------------------------------------------------------------- loss ----
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_matches_reference(arch):
    """The port's ``loss_fn`` at the start weights on the first batch: the
    total and its parts against the reference's first step (whose metrics
    are its ``loss_fn``'s), and the gradient's norm."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.interop import random_lm_state
    from repro_torch.models import LanguageModel
    from repro_torch.train import loss_fn
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import trainable

    ref = _reference(arch)
    cfg = get_smoke_config(arch)
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_lm_state(cfg).items()})
    params = trainable(model)
    batch = synthetic_batch(cfg, golden.BATCH, golden.SEQ,
                            seed=golden.DATA_SEED, step=0)
    total, parts = loss_fn(model, batch, golden.train_config())
    assert sorted(parts) == sorted(golden.PARTS)
    assert golden.rel(total.detach(), ref["loss"][0]) < TOL
    for k in golden.PARTS:
        assert golden.rel(parts[k].detach(), ref[k][0]) < TOL, k
    grads = torch.autograd.grad(total, list(params.values()))
    assert golden.rel(global_norm(grads), ref["grad_norm"][0]) < TOL
    if cfg.is_moe:
        assert float(parts["moe_aux"].detach()) > 0


# -------------------------------------------------------------- step ----
@pytest.mark.parametrize("arch", FAMILIES)
def test_three_steps_match_reference(arch):
    """Three steps from the start, and the last two from the reference's
    state after the first (params and moments carried by
    ``train_state_from_reference``): metrics, parameters and moments."""
    from repro_torch.interop import train_state_from_reference
    from repro_torch.configs import get_smoke_config

    ref = _reference(arch)
    got, _, _ = golden.port_run(arch, "cpu")
    golden.assert_runs_close(got, ref, TOL)
    start = train_state_from_reference(get_smoke_config(arch),
                                       *ref["start"])
    assert int(start[1]["step"]) == 1
    got, model, opt = golden.port_run(arch, "cpu", start=start, first=1)
    assert int(opt["step"]) == golden.STEPS
    assert golden.rel(got["loss"], ref["loss"][1:]) < TOL
    assert golden.rel(got["grad_norm"], ref["grad_norm"][1:]) < TOL
    worst = max((golden.rel(v, ref["params"][n]), n)
                for n, v in got["params"].items())
    assert worst[0] < TOL, worst
    for k in ("m", "v"):
        worst = max((golden.rel(t, ref["opt"][k][n]), n)
                    for n, t in opt[k].items())
        assert worst[0] < TOL, (k, worst)
        assert all(t.dtype == torch.float32 for t in opt[k].values())


def test_loss_decreases_on_learnable_stream():
    """The reference's own check: 30 steps of a tiny decoder on the noisy
    affine stream take the loss down by more than 0.5."""
    from repro_torch.data import synthetic_batch
    from repro_torch.models import LanguageModel, ModelConfig
    from repro_torch.train import (OptimizerConfig, TrainConfig, adamw_init,
                                   make_train_step)

    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                      d_ff=128, vocab_size=61, num_heads=4, num_kv_heads=2,
                      dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=100), remat=False)
    model = LanguageModel(cfg, device="cpu")
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    step = make_train_step(cfg, tcfg)
    losses = []
    for i in range(30):
        model, opt, m = step(model, opt, synthetic_batch(cfg, 8, 32, seed=1,
                                                         step=i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


# ------------------------------------------------------------ golden ----
@pytest.mark.parametrize("name", FAMILIES)
def test_golden_file_is_the_reference_s(name):
    """The stored entries are what the reference computes now."""
    arch, accum, remat = golden.ENTRIES[name]
    stored = golden.entry(golden.load(), name)
    ref = _reference(arch, accum, remat)
    assert sorted(stored) == sorted(k for k in ref
                                    if k not in ("start", "opt"))
    golden.assert_runs_close(stored, ref, 1e-6)


def _worst(dists):
    return {name: max(d.values()) for name, d in dists.items()}


def test_port_meets_golden_on_cpu():
    worst = _worst(golden.distances("cpu"))
    assert max(worst.values()) < GOLDEN_TOL, worst


@pytest.mark.cuda
def test_port_meets_golden_on_cuda():
    """The golden training runs on the card (TF32 off), bar 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = _worst(golden.distances("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert max(worst.values()) < GOLDEN_TOL, worst
