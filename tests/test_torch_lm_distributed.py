"""The LM training path's distribution substrate against the reference:
checkpoints (round trip, pruning, no ``.tmp`` left, bf16 restored
exactly, restore onto a device and dtype, the reference's layout), resume
equal to an uninterrupted run, bf16 compression and int8 error feedback,
the straggler monitor, the step timer and the elastic plan."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several workers a machine, whose thread pools would oversubscribe its
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ checkpoint ----
def test_checkpoint_roundtrip_and_pruning(tmp_path):
    from repro_torch.distributed import (available_steps, latest_step,
                                         restore_checkpoint, save_checkpoint)

    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.randn(4).to(torch.bfloat16),
                  torch.zeros((), dtype=torch.int32)]}
    for s in (1, 2, 3, 4):
        save_checkpoint(d, s, tree, keep=2)
    assert available_steps(d) == [3, 4]
    assert latest_step(d) == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    got, step = restore_checkpoint(d, tree)
    assert step == 4 and isinstance(got["b"], list)
    for a, b in ((got["a"], tree["a"]), (got["b"][0], tree["b"][0]),
                 (got["b"][1], tree["b"][1])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)  # bf16 widened to f32 and back: exact
    got, step = restore_checkpoint(d, tree, step=3)
    assert step == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


def test_checkpoint_layout_is_the_reference_s(tmp_path):
    """The same tree saved by both packages: the same directory names,
    manifest and arrays; each package restores the other's."""
    import jax.numpy as jnp

    from repro.distributed import restore_checkpoint as ref_restore
    from repro.distributed import save_checkpoint as ref_save
    from repro_torch.distributed import restore_checkpoint, save_checkpoint

    w = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    port = {"params": {"w": torch.from_numpy(w).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    ref = {"params": {"w": jnp.asarray(w, jnp.bfloat16)},
           "opt": {"step": jnp.asarray(7, jnp.int32)}}
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    pa = save_checkpoint(a, 5, port, extra={"note": 1})
    pb = ref_save(b, 5, ref, extra={"note": 1})
    assert os.path.basename(pa) == os.path.basename(pb) == "step_000000000005"
    ma = json.load(open(os.path.join(pa, "manifest.json")))
    mb = json.load(open(os.path.join(pb, "manifest.json")))
    assert ma == mb
    assert ma["keys"] == ["opt::step", "params::w"]
    with np.load(os.path.join(pa, "arrays.npz")) as fa, \
            np.load(os.path.join(pb, "arrays.npz")) as fb:
        for k in ma["keys"]:
            np.testing.assert_array_equal(fa[k], fb[k])
    got, _ = restore_checkpoint(b, port)
    assert torch.equal(got["params"]["w"], port["params"]["w"])
    want, _ = ref_restore(a, ref)
    np.testing.assert_array_equal(np.asarray(want["params"]["w"], np.float32),
                                  w.astype(jnp.bfloat16).astype(np.float32))


def test_checkpoint_restores_onto_device_and_dtype(tmp_path):
    from repro_torch.distributed import restore_checkpoint, save_checkpoint

    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(4.0)})
    template = {"w": torch.zeros(4, dtype=torch.float64)}
    got, _ = restore_checkpoint(str(tmp_path), template, device="cpu")
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], torch.arange(4.0, dtype=torch.float64))


def test_a_stale_tmp_is_replaced_and_never_listed(tmp_path):
    from repro_torch.distributed import available_steps, save_checkpoint

    os.makedirs(tmp_path / "step_000000000009.tmp")
    assert available_steps(str(tmp_path)) == []
    save_checkpoint(str(tmp_path), 9, {"x": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == ["step_000000000009"]


def test_resume_equals_uninterrupted(tmp_path):
    """Four steps straight against two, a checkpoint of params and AdamW
    state, a restore into a fresh model and two more: bit-equal (bf16
    parameters, bf16 moments and accumulator, grad_accum 2)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed import restore_checkpoint, save_checkpoint
    from repro_torch.models import LanguageModel
    from repro_torch.train import (OptimizerConfig, TrainConfig, adamw_init,
                                   make_train_step)

    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"),
                              dtype="bfloat16", param_dtype="bfloat16")
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=4,
        moment_dtype="bfloat16"), remat=False, grad_accum=2,
        accum_dtype="bfloat16")
    step = make_train_step(cfg, tcfg)

    def fresh():
        model = LanguageModel(cfg, device="cpu")
        return model, adamw_init(dict(model.named_parameters()),
                                 tcfg.optimizer)

    def run(model, opt, steps):
        for i in steps:
            model, opt, _ = step(model, opt, synthetic_batch(cfg, 4, 8,
                                                             seed=17, step=i))
        return model, opt

    straight, opt_s = run(*fresh(), range(4))
    model, opt = run(*fresh(), range(2))
    save_checkpoint(str(tmp_path), 2, {"params": model.state_dict(),
                                       "opt": opt})
    model, opt = fresh()
    state, at = restore_checkpoint(str(tmp_path), {
        "params": model.state_dict(), "opt": opt})
    assert at == 2 and int(state["opt"]["step"]) == 2
    model.load_state_dict(state["params"])
    model, opt = run(model, state["opt"], range(2, 4))
    want = straight.state_dict()
    assert want["embed"].dtype == torch.bfloat16  # the router stays f32
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k in ("m", "v"):
        for n, t in opt[k].items():
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, opt_s[k][n]), (k, n)


# ----------------------------------------------------------- compression ----
def test_bf16_compress_is_the_reference_s():
    import jax.numpy as jnp

    from repro.distributed import bf16_compress as ref_compress
    from repro_torch.distributed import bf16_compress

    g = np.linspace(-1, 1, 64, dtype=np.float32) * np.pi
    got = bf16_compress({"w": torch.from_numpy(g)})["w"]
    want = ref_compress({"w": jnp.asarray(g)})["w"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), g, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_error_feedback_is_the_reference_s(dtype):
    """Ten steps of the transform on the same gradients: the compressed
    gradients and the carried residual equal the reference's, and the
    sum of the compressed gradients tracks the true sum."""
    import jax.numpy as jnp

    from repro.distributed import make_int8_error_feedback as ref_make
    from repro_torch.distributed import make_int8_error_feedback

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    g_true = (rng.standard_normal(32) * 1e-3).astype(np.float32)
    transform, state = make_int8_error_feedback({"w": torch.zeros(32)})
    ref_transform, ref_state = ref_make({"w": jnp.zeros(32)})
    g = {"w": torch.from_numpy(g_true).to(tdt)}
    rg = {"w": jnp.asarray(g_true, jdt)}
    acc = np.zeros(32)
    for _ in range(10):
        c, state = transform(g, state)
        rc, ref_state = ref_transform(rg, ref_state)
        assert c["w"].dtype == tdt and state["w"].dtype == torch.float32
        np.testing.assert_allclose(c["w"].float().numpy(),
                                   np.asarray(rc["w"], np.float32),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state["w"].numpy(),
                                   np.asarray(ref_state["w"]),
                                   rtol=1e-6, atol=1e-9)
        acc += c["w"].float().numpy()
    want = 10 * g["w"].float().numpy()
    np.testing.assert_allclose(acc, want, rtol=0.05, atol=1e-4)


# -------------------------------------------------------- fault tolerance ----
def test_straggler_monitor_is_the_reference_s():
    from repro.distributed import StragglerMonitor as RefMonitor
    from repro_torch.distributed import StragglerMonitor

    rng = np.random.default_rng(1)
    mon = StragglerMonitor(num_hosts=5, window=4, threshold=1.5)
    ref = RefMonitor(num_hosts=5, window=4, threshold=1.5)
    assert mon.stragglers() == [] and mon.fleet_median() is None
    for t in range(12):
        for h in range(5):
            d = float(rng.random() + (2.5 if h == 2 else 0)
                      + (3.0 if h == 4 and t > 6 else 0))
            mon.record(h, d)
            ref.record(h, d)
        assert mon.stragglers() == ref.stragglers()
        assert mon.fleet_median() == ref.fleet_median()
    assert mon.stragglers() == [2, 4] and mon.healthy_hosts() == 3


def test_step_timer_syncs_before_the_clock_stops():
    from repro_torch.distributed import StepTimer, StragglerMonitor

    mon, calls = StragglerMonitor(num_hosts=2), []
    with StepTimer(mon, host=1, sync=lambda: calls.append(1)) as timer:
        pass
    assert calls == [1] and timer.last >= 0
    assert mon.fleet_median() == timer.last


@pytest.mark.parametrize("total,per_pod,surviving", [
    (64, 8, 49), (64, 8, 64), (64, 8, 3), (48, 4, 47), (16, 16, 16)])
def test_elastic_plan_is_the_reference_s(total, per_pod, surviving):
    from repro.distributed import ElasticPlan as RefPlan
    from repro_torch.distributed import ElasticPlan

    assert (ElasticPlan(total, per_pod).plan(surviving)
            == RefPlan(total, per_pod).plan(surviving))


# ------------------------------------------------------- placed forward ----
@pytest.mark.cuda
def test_placed_forward_on_gloo_ranks_sharing_the_card():
    """Two gloo ranks on the one card hold the smoke models of granite-3-8b
    (its heads, FFN and vocab split), deepseek-v2-236b (MLA by heads, 8
    experts 4 a rank, the shared expert by columns), grok-1-314b (4
    experts 2 a rank), recurrentgemma-2b (RG-LRU by width) and rwkv6-1.6b
    (RWKV-6 by heads) as DTensors on a (data=1, model=2) mesh, f32,
    sequence-parallel (each layer takes the rank's 4 of the 8 positions):
    each rank's logits within 1e-6 of one process's forward on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import placed_forward
    from repro_torch.launch.mesh import run_each, spawn_ranks
    from repro_torch.models import LanguageModel, forward

    archs = ("granite-3-8b", "deepseek-v2-236b", "grok-1-314b",
             "recurrentgemma-2b", "rwkv6-1.6b")
    tokens = {arch: np.random.default_rng(0).integers(
        0, get_smoke_config(arch).vocab_size, (2, 8)).astype(np.int32)
        for arch in archs}
    ranks = spawn_ranks(run_each, 2, backend="gloo", device="cuda", args=(
        [(placed_forward, (get_smoke_config(arch), (1, 2), tokens[arch]))
         for arch in archs],))
    for i, arch in enumerate(archs):
        cfg = get_smoke_config(arch)
        model = LanguageModel(cfg, device="cuda")
        with torch.inference_mode():
            want = forward(model, {"tokens": torch.as_tensor(
                tokens[arch], device="cuda")})[0].float().cpu().numpy()
        for r in (rk[i] for rk in ranks):
            err = np.abs(r["logits"] - want).max() / np.abs(want).max()
            assert err <= 1e-6, (arch, err)
            assert r["block_inputs"] == [(2, 4, cfg.d_model)] * len(
                cfg.layer_kinds), arch
    granite, deepseek, grok, rg, rwkv = (ranks[0][i] for i in range(5))
    assert granite["local_shapes"]["blocks.0.inner.wq.w"] == (64, 32)
    assert deepseek["used_shapes"]["blocks.1.inner.wk_b.w"] == (16, 32)
    assert deepseek["used_shapes"]["blocks.1.mlp.wi"] == (4, 64, 32)
    assert grok["used_shapes"]["blocks.0.mlp.wi"] == (2, 64, 64)
    assert rg["used_shapes"]["blocks.0.inner.wa.w"] == (64, 32)
    assert rg["used_shapes"]["blocks.0.inner.lam"] == (32,)
    assert rwkv["used_shapes"]["blocks.0.inner.wr.w"] == (64, 32)
    assert rwkv["used_shapes"]["blocks.0.inner.cm_r.w"] == (32, 64)
